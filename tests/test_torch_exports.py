"""The port's package exports against the JAX package's.

Every public name that a JAX-package ``__init__`` imports from one of its
modules (``from visionworkbench_tpu.<module> import ...``, or relative:
``from .common import ...``, ``from . import landsat``) resolves in the
port's ``__init__`` of the same package whenever the port has that module
(``visionworkbench_torch/<package>/<module>.py``). ``NOT_PORTED`` names the
modules the port has no counterpart of: none is left; ``LEFT_OUT`` the
names the port dropped on purpose. Importing the port's
packages loads neither ``jax`` nor ``visionworkbench_tpu``. Plus
``ops.box_sum_valid_int`` against the JAX package's (int32: equal).
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "visionworkbench_tpu"
PORT_PKG = ROOT / "visionworkbench_torch"

# JAX-package modules whose names its __init__s export and the port lacks
NOT_PORTED = set()
# names of ported modules the port left out on purpose: the per-stage
# megapixel counter (its steps are named by ``core/profiling.span``)
LEFT_OUT = {("core.profiling", "RateCounter")}


def _exports():
    """{package: [(module, name), ...]} of the JAX package's ``__init__``s
    (``from visionworkbench_tpu.<module> import <name>`` and relative
    ``from .<module> import <name>`` lines); ``from . import <module>``
    gives (``<package>.<module>``, None): the name is the module itself."""
    out = {}
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        pkg = ".".join(init.parent.relative_to(JAX_PKG).parts)
        for node in ast.parse(init.read_text()).body:
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level == 1:
                base = f"{pkg}.{node.module}" if node.module else None
                out.setdefault(pkg, []).extend(
                    (base, a.asname or a.name) if base else (f"{pkg}.{a.name}", None)
                    for a in node.names)
            elif node.module and node.module.startswith("visionworkbench_tpu."):
                mod = node.module[len("visionworkbench_tpu."):]
                out.setdefault(pkg, []).extend((mod, a.asname or a.name) for a in node.names)
    return out


EXPORTS = _exports()


def _ported(mod):
    path = PORT_PKG.joinpath(*mod.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def test_not_ported_lists_exactly_the_missing_modules():
    missing = {mod for names in EXPORTS.values() for mod, _ in names if not _ported(mod)}
    assert missing == NOT_PORTED


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_exports_resolve_in_the_port(pkg):
    names = [(mod, name) for mod, name in EXPORTS[pkg]
             if _ported(mod) and (mod, name) not in LEFT_OUT]
    if not names:
        assert all(mod in NOT_PORTED for mod, _ in EXPORTS[pkg])
        return
    port = importlib.import_module("visionworkbench_torch" + (f".{pkg}" if pkg else ""))
    attrs = [name or mod.rsplit(".", 1)[1] for mod, name in names]
    missing = [a for a in attrs if not hasattr(port, a)]
    assert not missing, f"visionworkbench_torch.{pkg} lacks {missing}"
    # each name is the object of its module in the port (or the module)
    for (mod, name), attr in zip(names, attrs):
        src = importlib.import_module(f"visionworkbench_torch.{mod}")
        assert getattr(port, attr) is (src if name is None else getattr(src, name)), (pkg, mod,
                                                                                      name)


def test_ported_packages_import_without_jax():
    pkgs = sorted(p for p in EXPORTS if p and PORT_PKG.joinpath(*p.split(".")).is_dir())
    assert {"geometry", "ba", "tools.flood"} <= set(pkgs)
    code = ("import sys\n"
            + "".join(f"import visionworkbench_torch.{p}\n" for p in pkgs)
            + "from visionworkbench_torch.math import ransac, levenberg_marquardt\n"
            + "from visionworkbench_torch.stereo import pyramid_correlate, StereoModel\n"
            + "import visionworkbench_torch.ops.sweep\n"
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'visionworkbench_tpu')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_lazy_stereo_names():
    import visionworkbench_torch.stereo as tst
    from visionworkbench_torch.stereo import pyramid_correlation
    assert tst.pyramid_correlate is pyramid_correlation.pyramid_correlate
    assert tst.max_pyramid_levels_for is pyramid_correlation.max_pyramid_levels_for
    with pytest.raises(AttributeError):
        tst.not_a_name  # noqa: B018


@pytest.mark.parametrize("kw, kh", [(5, 5), (3, 7), (1, 1)])
def test_box_sum_valid_int_matches_jax(kw, kh):
    from visionworkbench_tpu.ops import box_sum_valid_int as jbox
    from visionworkbench_torch.ops import box_sum_valid_int as tbox
    img = np.random.default_rng(kw * 10 + kh).integers(0, 50, (24, 31)).astype(np.int32)
    want = np.asarray(jbox(jnp.asarray(img), kw, kh))
    got = tbox(img, kw, kh, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tbox(torch.as_tensor(img), kw, kh).numpy(), want)
