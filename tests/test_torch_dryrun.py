"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``repro.launch.dryrun`` on the CPU.

* (a) Argument bytes: reduced Yi-6B, Zamba2-1.2B and DeepSeek-MoE-16B,
  ``train`` at 4 x 64 tokens on a ('data', 'model') = (2, 4) mesh: rank
  0's ``argument_size_in_bytes`` equals XLA's ``memory_analysis`` of the
  reference's jitted step (8 forced host devices, ``jax.make_mesh`` with
  Auto axes: the reference's ``rules.shard`` refuses Explicit ones on jax
  0.9), and the plan notes equal the reference's.  Output, alias and temp
  sizes count other things (XLA: a donated, fused program) and are
  printed, not compared.
* (d) The ``long_decode`` plan (the ``long_500k`` cells' context
  parallelism): reduced Mixtral-8x22B, RWKV6 and Zamba2, one decode step
  over a cache of 64 slots on the same (2, 4) mesh, rank 0's argument
  bytes and the plan notes equal XLA's (an argument the step never reads,
  RWKV6's ``pos``, is left out, as ``jax.jit`` leaves it out).
* (e) An argument a step never reads is left out on any plan: reduced
  Whisper-medium's decode step (2 x 64 cached positions on (2, 4)) reads
  none of the encoder's weights (its cross attention reads the cached K/V);
  rank 0's argument bytes equal XLA's.
* (f) Skips: the port skips exactly the cells the reference's
  ``cell_applicability`` skips, with the same text, for every arch and
  shape.
* (h) The CLI: ``python -m repro_torch.launch.dryrun --arch yi-6b --shape
  train_4k --device cpu`` on a reduced stand-in for Yi-6B on the 256-rank
  production mesh writes the artifact and exits 0; a skip cell exits 0; a
  failing cell exits 1, as the reference's ``main`` does.

Each side runs in its own subprocess (the reference needs 8 forced
devices, the port a fake default process group), both at once."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("yi-6b", "zamba2-1.2b", "deepseek-moe-16b")
LONG = ("mixtral-8x22b", "rwkv6-1.6b", "zamba2-1.2b")   # as "l:<arch>"
UNREAD = ("whisper-medium",)   # as "d:<arch>": decode leaves an input unread

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, json
jax.devices()                  # 8 devices before the dry run's import
from jax.sharding import AxisType
from repro.configs import get_reduced
from repro.configs.shapes import ShapeSpec
import repro.launch.dryrun as jd
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
jd.SHAPES["t"] = ShapeSpec("t", "train", 64, 4)
jd.SHAPES["l"] = ShapeSpec("l", "long_decode", 64, 1)
jd.SHAPES["d"] = ShapeSpec("d", "decode", 64, 2)
out = {}
for key in sys.argv[1:]:
    shape, arch = key.split(":") if ":" in key else ("t", key)
    cfg = get_reduced(arch)
    jd.get_config = lambda a, cfg=cfg: cfg
    (fn, args, shardings, donate, ctx), skip = jd.build_cell(arch, shape,
                                                            mesh)
    with mesh:
        compiled = jax.jit(fn, in_shardings=shardings,
                           donate_argnums=donate).lower(*args).compile()
    out[key] = {"memory": jd.memory_analysis_dict(compiled),
                "notes": list(ctx["plan_notes"])}
print("RESULT", json.dumps(out))
"""

PORT = r"""
import json, sys, tempfile
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
SHAPES = {"t": ShapeSpec("t", "train", 64, 4),
          "l": ShapeSpec("l", "long_decode", 64, 1),
          "d": ShapeSpec("d", "decode", 64, 2)}
out = {}
with dryrun.fake_process_group(8):
    for key in sys.argv[1:]:
        shape, arch = key.split(":") if ":" in key else ("t", key)
        rec = dryrun.run_cell(arch, SHAPES[shape],
                              multi_pod=False, out_dir=tempfile.mkdtemp(),
                              device="cpu", cfg=get_reduced(arch),
                              mesh_shape=(2, 4))
        out[key] = {"memory": rec.get("memory_analysis"),
                     "notes": rec.get("plan_notes"), "ok": rec["ok"],
                     "error": rec.get("error"), "rank": rec["rank"],
                     "chips": rec["chips"], "mesh": rec["mesh"],
                     "collectives": rec.get("collectives")}
print("RESULT", json.dumps(out))
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1", **extra)


def _start(code, *args):
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=REPO)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0 and "RESULT" in out, err[-3000:]
    return json.loads(out.split("RESULT", 1)[1])


@pytest.fixture(scope="module")
def both():
    keys = (ARCHS + tuple("l:" + arch for arch in LONG)
            + tuple("d:" + arch for arch in UNREAD))
    ref, port = _start(REFERENCE, *keys), _start(PORT, *keys)
    return _result(ref), _result(port)


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_xla(both, arch):
    ref, port = both[0][arch], both[1][arch]
    assert port["ok"], port["error"]
    assert (port["rank"], port["chips"], port["mesh"]) == (0, 8, "mesh2x4")
    print(arch, "XLA", ref["memory"], "port", port["memory"])
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert port["notes"] == ref["notes"]
    assert port["collectives"]["total_operand_bytes"] > 0


@pytest.mark.parametrize("arch", LONG)
def test_long_decode_argument_bytes_equal_xla(both, arch):
    ref, port = both[0]["l:" + arch], both[1]["l:" + arch]
    assert port["ok"], port["error"]
    print(arch, "XLA", ref["memory"], "port", port["memory"])
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert port["notes"] == ref["notes"]
    assert "long_500k: context-parallel (seq/cache over data axes)" in \
        port["notes"]


@pytest.mark.parametrize("arch", UNREAD)
def test_unread_arguments_are_left_out_as_xla_does(both, arch):
    ref, port = both[0]["d:" + arch], both[1]["d:" + arch]
    assert port["ok"], port["error"]
    print(arch, "XLA", ref["memory"], "port", port["memory"])
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]


def test_skips_are_the_references():
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import all_arch_names as j_archs
    from repro.configs import cell_applicability as j_skip
    from repro.configs import get_config as j_config
    from repro_torch.configs import (
        SHAPES, all_arch_names, cell_applicability, get_config,
    )
    from repro_torch.launch import dryrun
    assert all_arch_names() == j_archs() and list(SHAPES) == list(J_SHAPES)
    skipped = []
    for arch in all_arch_names():
        for name in SHAPES:
            want = j_skip(j_config(arch), J_SHAPES[name])
            assert cell_applicability(get_config(arch), SHAPES[name]) == \
                want, (arch, name)
            if want:        # the dry run skips it with that text
                assert dryrun.build_cell(arch, name, None) == (None, want)
                skipped.append((arch, name))
    # long_500k for the seven full-attention archs (mixtral's window makes
    # its decode sub-quadratic); every arch has a decode step
    assert len(skipped) == 7
    assert {name for _, name in skipped} == {"long_500k"}


CLI = r"""
import runpy, sys
import repro_torch.configs as configs
configs.get_config = configs.get_reduced       # a reduced stand-in
if sys.argv[1] == "fail":                      # a cell whose step raises
    import repro_torch.train.loop as loop
    def broken(*a, **k):
        raise RuntimeError("the step cannot be built")
    loop.make_train_step = broken
sys.argv = ["dryrun"] + sys.argv[2:]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
"""


def _cli(mode, *args):
    return subprocess.run([sys.executable, "-c", CLI, mode, *args],
                          capture_output=True, text=True, env=_env(),
                          cwd=REPO, timeout=600)


def test_cli_runs_a_cell_and_exits_as_the_reference(tmp_path):
    out = str(tmp_path)
    r = _cli("ok", "--arch", "yi-6b", "--shape", "train_4k", "--device",
             "cpu", "--out", out)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("[pod16x16] yi-6b              train_4k"
                               "     ok trace=")
    assert lines[-1] == "done: ok=1 skip=0 fail=0"
    with open(os.path.join(out, "yi-6b__train_4k__pod16x16.json")) as f:
        rec = json.load(f)
    for key in ("memory_analysis", "cost_analysis", "collectives",
                "corrected", "plan_notes", "chips", "ok", "rank", "counted",
                "trace_s"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["rank"] == 0 and rec["ok"]
    assert set(rec["collectives"]) == {"by_op", "counts",
                                       "total_operand_bytes"}
    assert rec["corrected"]["scan_correction"]["extra_flops"] == 0

    r = _cli("ok", "--arch", "yi-6b", "--shape", "long_500k", "--device",
             "cpu", "--out", out)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SKIP (full-attention arch: long_500k needs sub...)" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "done: ok=0 skip=1 fail=0"

    r = _cli("fail", "--arch", "yi-6b", "--shape", "train_4k", "--device",
             "cpu", "--out", out, "--variant", "broken")
    assert r.returncode == 1
    assert "FAIL RuntimeError: the step cannot be built" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "done: ok=0 skip=0 fail=1"
    with open(os.path.join(
            out, "yi-6b__train_4k__pod16x16__broken.json")) as f:
        rec = json.load(f)
    assert rec["ok"] is False and "traceback" in rec
