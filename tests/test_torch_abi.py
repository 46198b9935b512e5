"""The ctypes signatures of ``oasisx_tpu_torch._build`` against the C
entry points of ``csrc/*.cu``: every ``extern "C"`` function has one, with
one argtype per parameter of the matching kind (a pointer as ``c_void_p``,
``int`` as ``c_int``, ``int64_t`` / ``long long`` as ``c_longlong``,
``double`` as ``c_double``).  ctypes cannot see a C declaration, so a
parameter added to or dropped from an entry point and not from its
signature would pass every argument after it in the wrong place on the
card; here it fails on the CPU, where nothing is compiled.
"""

import re

import pytest

pytest.importorskip("torch")

from oasisx_tpu_torch import _build  # noqa: E402


def _c_entry_points() -> dict:
    """name -> [parameter declarations] of every ``int oasisx_*(...) {`` in
    the ``extern "C"`` part of each source."""
    out = {}
    for src in sorted(_build._CSRC.glob("*.cu")):
        text = src.read_text()
        start = text.find('extern "C" {')
        assert start >= 0, src.name
        for m in re.finditer(r"^int (oasisx_\w+)\(([^)]*)\)\s*\{", text[start:], re.M):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            assert m.group(1) not in out, m.group(1)
            out[m.group(1)] = params
    return out


def _kind(decl: str):
    t = decl.rsplit(" ", 1)[0] if " " in decl else decl
    if "*" in decl:
        return _build.P
    if t in ("int64_t", "long long"):
        return _build.LL
    if t == "double":
        return _build.D
    assert t == "int", decl
    return _build.I


ENTRY = _c_entry_points()


def test_every_entry_point_has_a_signature():
    assert set(ENTRY) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    params = ENTRY[name]
    if params == ["void"]:
        params = []
    assert [_kind(p) for p in params] == list(_build._SIGNATURES[name]), params
