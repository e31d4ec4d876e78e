"""The port's AST lint (``repro_torch.analysis.lint``): ``host-op`` over
the hot paths, ``ctypes-arity`` between ``kernels/build.py`` and the
``extern "C"`` entry points of ``kernels/csrc``, and ``hygiene``.  The
repository is clean; each rule trips on a planted fault; suppression and
reachability behave; a stale root is reported."""

import pytest

from port_fixtures import _one_torch_thread  # noqa: F401
from repro_torch.analysis import lint

ROOT = ("models/transformer.py", "paged_decode_step")
HOT = {"repro_torch/models/transformer.py": (
    "from .helpers import helper\n"
    "def paged_decode_step(x):\n"
    "    return helper(x)\n"
    "def cold(x):\n"
    "    return x.item()\n"),
    "repro_torch/models/helpers.py": (
    "import numpy as np\n"
    "def helper(x):\n"
    "    y = x{call}\n"
    "    return y\n")}


def _files(call: str) -> dict:
    return {k: v.replace("{call}", call) for k, v in HOT.items()}


def test_repository_is_clean():
    assert lint.lint_repo() == []
    assert lint.hygiene_repo() == []


@pytest.mark.parametrize("call", [".item()", ".tolist()", ".cpu()",
                                  ".numpy()"])
def test_host_op_flagged_where_reachable(call):
    vios = lint.lint_sources(_files(call), roots=(ROOT,))
    assert [(v.file, v.line, v.rule) for v in vios] == [
        ("repro_torch/models/helpers.py", 3, "host-op")]
    assert "hot-path root" in vios[0].message


def test_numpy_and_synchronize_flagged():
    files = _files(".sum()")
    files["repro_torch/models/helpers.py"] += (
        "def more(x):\n    import torch\n    torch.cuda.synchronize()\n"
        "    return np.asarray(x)\n")
    files["repro_torch/models/helpers.py"] = files[
        "repro_torch/models/helpers.py"].replace("return y", "return more(y)")
    msgs = [v.message for v in lint.lint_sources(files, roots=(ROOT,))]
    assert len(msgs) == 2
    assert any("synchronize" in m for m in msgs)
    assert any("np.asarray" in m for m in msgs)


def test_suppression_with_a_reason():
    vios = lint.lint_sources(
        _files(".item()  # lint: host-ok: a static count"), roots=(ROOT,))
    assert vios == []


def test_unreachable_code_is_ignored():
    # cold() calls .item() but no root reaches it
    assert lint.lint_sources(_files(".sum()"), roots=(ROOT,)) == []


def test_stale_root_is_reported():
    vios = lint.lint_sources(_files(".sum()"),
                             roots=(("models/transformer.py", "gone"),))
    assert len(vios) == 1 and "not found" in vios[0].message


BUILD = ('import ctypes\n_P, _I = ctypes.c_void_p, ctypes.c_int\n'
         '_SIGNATURES = {\n'
         '    "foo_launch": [_P] * 2 + [_I] * {n} + [_P],\n}\n')
CU = {"foo.cu": 'extern "C" int foo_launch(const void* a, void* b, int n,\n'
                '                          int m, void* stream) {\n'
                '  return 0;\n}\n'}


def test_ctypes_arity_matches():
    assert lint.ctypes_arity(BUILD.replace("{n}", "2"), CU) == []


def test_ctypes_arity_mismatch_caught():
    vios = lint.ctypes_arity(BUILD.replace("{n}", "1"), CU)
    assert len(vios) == 1 and vios[0].rule == "ctypes-arity"
    assert "4 argtypes for the 5 parameters" in vios[0].message


def test_launch_call_arity_caught():
    files = {"repro_torch/kernels/build.py": BUILD.replace("{n}", "2"),
             "repro_torch/kernels/foo.py": (
                 "from .build import launch\n"
                 "def foo(a, b, s):\n"
                 "    launch('foo', 'foo_launch', a, b, 1, 2, s)\n"
                 "    launch('foo', 'foo_launch', a, b, 1, s)\n")}
    vios = lint.lint_sources(files, cuda_sources=CU)
    assert [(v.file, v.line) for v in vios] == [
        ("repro_torch/kernels/foo.py", 4)]
    assert "passes 4 arguments to foo_launch" in vios[0].message


def test_unbound_entry_point_caught():
    cu = dict(CU, **{"bar.cu": 'extern "C" int bar_geometry(int n) {}\n'})
    vios = lint.ctypes_arity(BUILD.replace("{n}", "2"), cu)
    assert len(vios) == 1 and "bar_geometry has no argtypes" in \
        vios[0].message


def test_hygiene_flags_tracked_bytecode():
    vios = lint.hygiene_scan(["src/a.py", "src/__pycache__/a.cpython-312.pyc",
                              "b.pyc"])
    assert [v.file for v in vios] == ["src/__pycache__/a.cpython-312.pyc",
                                      "b.pyc"]
    assert all(v.rule == "hygiene" for v in vios)
