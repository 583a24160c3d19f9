"""The ctypes signatures in ``kernels/ops.py`` against the ``extern "C"``
entry points in ``kernels/csrc``.

A wrapper that declares a pointer where the C function takes an int (or
one argument too few) passes a pointer cut to 32 bits, which faults only
on the card; this reads the C declarations and catches it on the CPU."""
import ctypes
import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _c_params(source: str, name: str):
    """Parameter kinds of ``extern "C" int name(...)`` in ``source``."""
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(name) + r"\s*\(([^)]*)\)",
                  source)
    assert m, f'no extern "C" int {name}(...) declaration'
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append("pointer")
        elif re.match(r"(const )?float\b", param):
            kinds.append("float")
        elif re.match(r"(const )?int\b", param):
            kinds.append("int")
        else:
            raise AssertionError(f"unclassified parameter {param!r}")
    return kinds


def test_sources_name_every_library():
    libs = {lib for lib, _ in ops._SIGNATURES}
    assert libs == set(build.SOURCES)
    for src in build.SOURCES.values():
        assert (build.CSRC / src).is_file()


@pytest.mark.parametrize("lib,name", sorted(ops._SIGNATURES),
                         ids=lambda x: str(x))
def test_ctypes_argtypes_match_c_declaration(lib, name):
    source = (build.CSRC / build.SOURCES[lib]).read_text()
    want = _c_params(source, name)
    got = [_KIND[t] for t in ops._SIGNATURES[(lib, name)]]
    assert got == want, (f"{name}: ctypes {got} vs C {want}")


def test_parser_catches_a_mismatch():
    src = 'extern "C" int f(const void* a, int n, float x, void* s) {}'
    assert _c_params(src, "f") == ["pointer", "int", "float", "pointer"]
    assert _c_params(src, "f") != [_KIND[t] for t in
                                   [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]]
