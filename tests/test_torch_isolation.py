"""The port stands alone: ``repro_torch`` and ``chip_smoke`` import with
jax made unimportable, and load no module of the JAX package."""
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
    assert n >= 20, r.stdout
