"""The port stands alone: importing ``synapseml_tpu_torch`` and every one of its
modules loads neither JAX nor the JAX package, and ``chip_smoke.py`` names
neither. Checked in a subprocess, immune to what this pytest session imported
(conftest.py imports jax eagerly)."""

import os
import pkgutil
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import synapseml_tpu_torch

    mods = ["synapseml_tpu_torch"]
    for info in pkgutil.walk_packages(synapseml_tpu_torch.__path__, "synapseml_tpu_torch."):
        mods.append(info.name)
    return mods


def test_port_modules_import_no_jax_and_no_reference():
    mods = _port_modules()
    assert "synapseml_tpu_torch.gbdt.estimators" in mods
    assert "synapseml_tpu_torch.parallel.flash" in mods
    assert "synapseml_tpu_torch.gbdt.sparse" in mods
    for sub in ("gbdt.dataset", "stages.basic", "featurize.stages", "train.stages",
                "exploratory.balance", "cyber.scalers", "native.murmur"):
        assert f"synapseml_tpu_torch.{sub}" in mods, sub
    code = "\n".join(
        ["import sys", f"sys.path.insert(0, {_ROOT!r})"]
        + [f"import {m}" for m in mods]
        + ["import synapseml_tpu_torch.kernels as k; k.all_kernels()",
           "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
           "or m == 'synapseml_tpu' or m.startswith('synapseml_tpu.'))",
           "assert not bad, f'imported at module import time: {bad[:5]}'"])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=_ROOT)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_names_neither_jax_nor_the_reference():
    with open(os.path.join(_ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"\bsynapseml_tpu\b(?!_torch)", src)
    assert not re.search(r"\bjax\b", src)


def test_sparse_hist_binding_matches_its_source():
    """Kernel G is registered, bound to ``csrc/sparse_hist.cu``'s entry point,
    and ``_GArgs`` mirrors the source's ``GArgs`` field for field."""
    from synapseml_tpu_torch.gbdt import sparse
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.kernels.build import CSRC_DIR

    k = all_kernels()["gbdt_sparse_hist"]
    assert k is sparse.SPARSE_HIST_KERNEL and k.source == "sparse_hist"
    src = (CSRC_DIR / "sparse_hist.cu").read_text()
    assert f'extern "C" int {k.symbol}(' in src
    body = re.search(r"struct GArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            head, _, names = decl.rpartition(" ") if "," not in decl else \
                (decl.split()[0], None, decl.split(None, 1)[1])
            fields += [n.strip().lstrip("*") for n in names.split(",")]
    assert fields == [name for name, _ in sparse._GArgs._fields_]
