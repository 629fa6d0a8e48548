"""The port stands alone: ``repro_torch`` (every subpackage: the graph
engine, ``configs``, ``models``, ``serve``, ``sharding``, ``data``,
``runtime``, ``ckpt``, ``train``, ``launch``), ``chip_smoke`` and the
port's examples import with jax made unimportable, and load no module of
the JAX package."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # its main() runs only under __main__
import glob, importlib.util, os
for path in sorted(glob.glob(os.path.join("examples", "*_torch.py"))):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
for sub in ("configs", "models", "serve", "sharding", "data", "train",
            "launch"):
    assert any(n.startswith(f"repro_torch.{sub}.") for n in names), sub
assert sum(n.endswith("_torch.py") for n in names) >= 4, names
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
assert not bad, bad
print("ISOLATED", len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    n = int(r.stdout.split("ISOLATED")[1])
    assert n >= 50, r.stdout
