"""The port stands alone: importing ``synapseml_tpu_torch`` and every one of its
modules loads neither JAX nor the JAX package, and ``chip_smoke.py`` names
neither. Checked in a subprocess, immune to what this pytest session imported
(conftest.py imports jax eagerly)."""

import ctypes
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
                "exploratory.balance", "cyber.scalers", "native.murmur", "runtime.layout",
                "runtime.collectives", "vw.learner", "vw.estimators", "vw.featurizer",
                "vw.convert", "onnx.wire", "onnx.builder", "onnx.ops", "onnx.qgemm", "onnx.rnn",
                "onnx.importer", "onnx.model", "models.zoo", "tools.onnx_graphs",
                "parallel.ring", "runtime.topology", "gbdt.engine", "image.ops",
                "image.stages", "image.resample", "io.binary", "io.http", "dl.downloader",
                "dl.featurizer", "explainers.regression", "explainers.lime",
                "explainers.shap", "explainers.ice", "explainers.superpixel",
                "isolationforest.forest", "nn.topk", "nn.knn", "recommendation.sar",
                "recommendation.ranking", "cyber.anomaly", "tools.schema_data"):
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


def test_mesh_modules_and_rank_side_import_no_jax_and_no_reference():
    """The mesh's modules and the rank side of the mesh tests (the module
    that gloo ranks import, ``tests/torch_mesh.py``) load neither JAX nor
    the JAX package, and name neither in an import."""
    files = [os.path.join(_ROOT, "synapseml_tpu_torch", "runtime", f)
             for f in ("layout.py", "collectives.py", "topology.py")]
    files += [os.path.join(_ROOT, "synapseml_tpu_torch", "parallel", "ring.py"),
              os.path.join(_ROOT, "synapseml_tpu_torch", "gbdt", "engine.py"),
              os.path.join(_ROOT, "tests", "torch_mesh.py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
        assert not re.search(r"^\s*(import|from)\s+synapseml_tpu\b(?!_torch)", src, re.M), path
    code = "\n".join(
        ["import sys", f"sys.path.insert(0, {_ROOT!r})",
         "import synapseml_tpu_torch.runtime.layout, synapseml_tpu_torch.runtime.collectives",
         "import synapseml_tpu_torch.runtime.topology, synapseml_tpu_torch.parallel.ring",
         "import synapseml_tpu_torch.gbdt.engine, synapseml_tpu_torch.onnx.importer",
         "import tests.torch_mesh",
         "assert {'attention', 'topology', 'layout_specs', 'dryrun', 'onnx'} <= "
         "set(tests.torch_mesh.CASES)",
         "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
         "or m == 'synapseml_tpu' or m.startswith('synapseml_tpu.'))",
         "assert not bad, f'imported: {bad[:5]}'"])
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


def test_partition_binding_matches_its_source():
    """Kernel P's one-launch step, its mesh entry and its pick are bound to
    ``csrc/partition.cu``'s entry points, and ``_PartArgs`` mirrors the
    source's ``PartArgs`` field for field (the mesh entry's ``counts`` and
    ``mesh`` included)."""
    from synapseml_tpu_torch.gbdt import partition
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.kernels.build import CSRC_DIR

    ks = all_kernels()
    src = (CSRC_DIR / "partition.cu").read_text()
    for name, k in (("gbdt_partition", partition.PARTITION_KERNEL),
                    ("gbdt_partition_mesh", partition.PARTITION_MESH_KERNEL),
                    ("gbdt_partition_pick", partition.PARTITION_PICK_KERNEL)):
        assert ks[name] is k and k.source == "partition"
        assert f'extern "C" int {k.symbol}(' in src
    body = re.search(r"struct PartArgs \{(.*?)\};", src, re.S).group(1)
    fields = [decl.strip().split()[-1].lstrip("*")
              for decl in re.sub(r"//[^\n]*", "", body).split(";") if decl.strip()]
    assert fields == [name for name, _ in partition._PartArgs._fields_]


def test_vw_step_binding_matches_its_source():
    """Kernel V is registered, bound to ``csrc/vw_step.cu``'s entry point,
    and ``_VArgs`` mirrors the source's ``VArgs`` field for field, type for
    type."""
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.kernels.build import CSRC_DIR
    from synapseml_tpu_torch.vw import learner

    k = all_kernels()["vw_step"]
    assert k is learner.VW_KERNEL and k.source == "vw_step"
    src = (CSRC_DIR / "vw_step.cu").read_text()
    assert f'extern "C" int {k.symbol}(' in src
    body = re.search(r"struct VArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            kind, names = decl.split(None, 1) if "*" not in decl else \
                (decl.rsplit(None, 1)[0], decl.rsplit(None, 1)[1])
            kind = "ptr" if "*" in decl else kind
            fields += [(n.strip().lstrip("*"), kind) for n in names.split(",")]
    ctype = {ctypes.c_void_p: "ptr", ctypes.c_float: "float", ctypes.c_int: "int"}
    assert fields == [(name, ctype[t]) for name, t in learner._VArgs._fields_]


def test_onnx_modules_import_no_ml_dtypes_and_name_neither_package():
    """The ONNX executor, the zoo and the graph tools load no ``ml_dtypes``
    (numpy's bfloat16; the card's machine has none), and name neither JAX nor
    the JAX package in an import; ``chip_smoke.py`` imports no ``ml_dtypes``."""
    pkg = os.path.join(_ROOT, "synapseml_tpu_torch")
    files = [os.path.join(pkg, "onnx", f) for f in sorted(os.listdir(os.path.join(pkg, "onnx")))
             if f.endswith(".py")]
    files += [os.path.join(pkg, "models", "zoo.py"), os.path.join(pkg, "tools", "onnx_graphs.py"),
              os.path.join(_ROOT, "chip_smoke.py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not re.search(r"^\s*(import|from)\s+(jax|ml_dtypes)\b", src, re.M), path
        assert not re.search(r"^\s*(import|from)\s+synapseml_tpu\b(?!_torch)", src, re.M), path
    code = "\n".join(
        ["import sys", f"sys.path.insert(0, {_ROOT!r})",
         "import synapseml_tpu_torch.onnx.importer, synapseml_tpu_torch.onnx.model",
         "import synapseml_tpu_torch.models.zoo, synapseml_tpu_torch.tools.onnx_graphs",
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'ml_dtypes', 'synapseml_tpu'))",
         "assert not bad, f'imported: {bad[:5]}'"])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=_ROOT)
    assert proc.returncode == 0, proc.stderr


def _struct_fields(src: str, name: str):
    """(field, kind) of ``struct <name>`` in a CUDA source: kind "ptr",
    "long long", "float" or "int"."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        if "*" in decl:
            kind, names = "ptr", decl.split("*", 1)[1]
            names = names.replace("*", "")
        else:
            parts = decl.split()
            n_kind = 2 if parts[:2] == ["long", "long"] else 1
            kind, names = " ".join(parts[:n_kind]), " ".join(parts[n_kind:])
        fields += [(n.strip(), kind) for n in names.split(",")]
    return fields


def test_qgemm_and_rnn_bindings_match_their_sources():
    """Kernels Q (three entries) and R (two entries) are registered, bound to
    ``csrc/qgemm.cu`` / ``csrc/rnn_step.cu``, and ``_QArgs`` / ``_RArgs``
    mirror the sources' ``QArgs`` / ``RArgs`` field for field, type for type."""
    from synapseml_tpu_torch.kernels import all_kernels
    from synapseml_tpu_torch.kernels.build import CSRC_DIR
    from synapseml_tpu_torch.onnx import qgemm, rnn

    ks = all_kernels()
    ctype = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "long long", ctypes.c_float: "float",
             ctypes.c_int: "int"}
    for kernels, mod, struct, args in (
            ((qgemm.QMATMUL_KERNEL, qgemm.QCONV_KERNEL, qgemm.QCL_KERNEL), qgemm, "QArgs",
             qgemm._QArgs),
            ((rnn.RNN_KERNEL, rnn.RNN_STEP_KERNEL), rnn, "RArgs", rnn._RArgs)):
        src = (CSRC_DIR / f"{kernels[0].source}.cu").read_text()
        for k in kernels:
            assert ks[k.name] is k
            assert f'extern "C" int {k.symbol}(' in src
        assert _struct_fields(src, struct) == [(n, ctype[t]) for n, t in args._fields_]
