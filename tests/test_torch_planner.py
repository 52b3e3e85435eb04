"""The port's planner against the JAX package's, and the port's import rule.

The planner is a jax-free copy inside `repro_torch`; its decisions and
every cost field must equal the reference's (floats within 1e-12
relative — they are the same arithmetic in the same order).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import DeviceInfo as JDeviceInfo
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.core.api import search_serve as jsearch_serve
from repro.core.descriptions import describe as jdescribe
from repro_torch.configs import DeviceInfo as TDeviceInfo
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.core.api import search_serve as tsearch_serve
from repro_torch.core.descriptions import describe as tdescribe

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _same(a, b, path="") -> None:
    """Recursive equality across the two packages' dataclasses; floats
    within 1e-12 relative."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-12 * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


# (arch, kwargs of search_serve); the device preset is named, not passed
SERVE_ROWS = [
    ("phi4-mini-3.8b", dict(prompt_len=512, decode_len=64, n_devices=1,
                            memory_limit_gib=64.0), "h100-sxm"),
    ("qwen1.5-0.5b", dict(n_devices=8, memory_limit_gib=1.0), None),
    ("llama3-405b", dict(n_devices=8, memory_limit_gib=16.0), None),
    ("hymba-1.5b", dict(n_devices=1, memory_limit_gib=16.0), None),
]


@pytest.mark.parametrize("arch,kw,preset", SERVE_ROWS,
                         ids=[r[0] for r in SERVE_ROWS])
def test_search_serve_identical(arch, kw, preset):
    jdev = JDeviceInfo.preset(preset) if preset else None
    tdev = TDeviceInfo.preset(preset) if preset else None
    ref = jsearch_serve(jget_arch(arch), device=jdev, **kw)
    got = tsearch_serve(tget_arch(arch), device=tdev, **kw)
    skip = {"search_seconds", "inner"}
    for f in dataclasses.fields(ref):
        if f.name not in skip:
            _same(getattr(ref, f.name), getattr(got, f.name), f.name)
    if ref.inner is not None:
        _same(ref.inner.decisions, got.inner.decisions, "inner.decisions")
        _same(ref.inner.cost, got.inner.cost, "inner.cost")
    assert ref.summary() == got.summary()
    if arch == "llama3-405b":
        # the infeasible row: the repair plan shards every matrix op
        assert not got.feasible
        assert all(d.uniform() == "ZDP" for k, d in got.decisions.items()
                   if "norm" not in k and k != "layers.attn_scores")


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen1.5-0.5b",
                                  "llama3-405b", "hymba-1.5b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_describe_identical(arch, shape):
    _same(jdescribe(jget_arch(arch), jget_shape(shape)),
          tdescribe(tget_arch(arch), tget_shape(shape)))


# --- the import rule ---------------------------------------------------------

def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_repro():
    """Every module of the port imports with `jax` and `repro` blocked."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_repro_import_in_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)
