"""The port imports neither JAX nor the JAX package, so a host with a GPU
needs no JAX install: every module of sparse_coding_tpu_torch (and
chip_smoke.py) imports in a subprocess whose meta-path blocks jax, flax,
optax and sparse_coding_tpu — and transformers, datasets and zstandard,
which the LM and harvest modules import only inside the functions that
need them, and sklearn and matplotlib, which the baseline dicts, the
probes, the clusterings and the plots import only there too — and a
source scan finds no such import."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "sparse_coding_tpu_torch"

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "sparse_coding_tpu",
           "transformers", "datasets", "zstandard", "sklearn", "matplotlib",
           "openai")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import sparse_coding_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""

# the modules of the model zoo, the metrics and the reference interop
ZOO = ("models.lista", "models.pca", "models.positive", "models.rica",
       "models.semilinear", "models.topk", "metrics.core",
       "utils.ref_interop", "utils.checkpoint", "utils.tree",
       "data.synthetic", "train.experiments")
# the LM and harvest modules
HARVEST = ("lm.model_config", "lm.hooks", "lm.gptneox", "lm.gpt2",
           "lm.convert", "data.tokenize", "data.harvest", "data.scrub",
           "data.generate")
# the evaluation stage, the baseline dicts and their trainers
EVALS = ("metrics.intervention", "metrics.geometry", "metrics.erasure",
         "metrics.erasure_driver", "plotting.erasure", "tasks.ioi",
         "tasks.ioi_counterfact", "tasks.gender", "tasks.feature_ident",
         "models.ica", "models.nmf", "models.direct_coef",
         "models.combination", "train.baselines", "train.toy_models")
# interpretation, the catalog and the rest of plotting
INTERP = ("interp.client", "interp.fragments", "interp.run", "interp.graph",
          "catalog", "catalog.build", "catalog.query", "utils.trees",
          "plotting.helpers", "plotting.frontiers", "plotting.sweeps",
          "plotting.autointerp", "plotting.timeseries")

_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|sparse_coding_tpu)\b"
    r"(?!_torch)", re.MULTILINE)
_DYNAMIC = re.compile(
    r"(?:import_module|__import__)\(\s*['\"](jax|flax|optax|"
    r"sparse_coding_tpu)(?!_torch)")


def test_port_imports_under_a_jax_blocker():
    from conftest import stripped_cpu_subprocess_env

    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=stripped_cpu_subprocess_env())
    assert out.returncode == 0, out.stderr[-2000:]
    names = out.stdout.split()
    assert len(names) >= 20
    assert {f"sparse_coding_tpu_torch.{m}"
            for m in ZOO + HARVEST + EVALS + INTERP} <= set(names)


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        text = path.read_text()
        assert not _IMPORT.search(text), path
        assert not _DYNAMIC.search(text), path
