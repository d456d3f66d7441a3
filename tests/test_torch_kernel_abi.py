"""The boundary between the CUDA sources and their ctypes bindings, checked
on the CPU (the sources compile only on the card).

Every `extern "C" int sg_*(...)` in `singa_tpu_torch/csrc/*.cu` must be
declared in `ops/attention.py:_SIGNATURES` with one ctypes type a
parameter: a pointer or the stream `c_void_p`, an `int` `c_int`, a `float`
`c_float`. A wrong declaration compiles and loads, then passes a pointer
as 32 bits or a float as an int, silently. Every entry must also live in a
source that `ops/_build.SOURCES` builds (or, for a diagnostic tool's
source, `_build.DIAGNOSTICS`), and every header a source includes
(directly or through another header) must exist in `csrc/`.
"""

import ctypes
import os
import re

import pytest

from singa_tpu_torch.ops import _build
from singa_tpu_torch.ops import attention as ta

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(sg_\w+)\s*\(([^)]*)\)', re.S)
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _read(name):
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


def _sources():
    return sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))


BUILT = _build.SOURCES + _build.DIAGNOSTICS


def parse_entries(text):
    """{entry name: [ctypes type of each parameter]} of the C entry points
    in a source's text."""
    out = {}
    for name, params in ENTRY.findall(text):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if "*" in p:
                types.append(ctypes.c_void_p)
            elif re.match(r"^(const\s+)?int\s+\w+$", p):
                types.append(ctypes.c_int)
            elif re.match(r"^(const\s+)?float\s+\w+$", p):
                types.append(ctypes.c_float)
            else:
                raise ValueError(f"{name}: parameter {p!r} has no ctypes rule")
        out[name] = types
    return out


def mismatches(entries, signatures):
    """Entries whose declared ctypes list differs from the C parameters,
    and declarations with no C entry."""
    bad = [n for n, types in entries.items() if signatures.get(n) != types]
    return bad + [n for n in signatures if n not in entries]


ENTRIES = {name: (src, types) for src in _sources()
           for name, types in parse_entries(_read(src)).items()}


def test_every_source_has_an_entry_and_is_built():
    """Each .cu exports at least one entry, and the build sets are exactly
    the .cu files of csrc/, each in one set."""
    assert not set(_build.SOURCES) & set(_build.DIAGNOSTICS)
    assert sorted(f"{s}.cu" for s in BUILT) == _sources()
    assert {src for src, _ in ENTRIES.values()} == set(_sources())


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_signature_matches_ctypes(name):
    src, types = ENTRIES[name]
    assert name in ta._SIGNATURES, f"{name} ({src}) has no ctypes signature"
    assert ta._SIGNATURES[name] == types, (
        f"{name} in csrc/{src}: C parameters {[t.__name__ for t in types]}, "
        f"ctypes {[t.__name__ for t in ta._SIGNATURES[name]]}")
    assert src[:-3] in BUILT


def test_no_signature_without_an_entry():
    assert mismatches({n: t for n, (_, t) in ENTRIES.items()},
                      ta._SIGNATURES) == []


@pytest.mark.parametrize("src", _sources())
def test_included_headers_exist(src):
    seen, todo = set(), [src]
    while todo:
        for inc in INCLUDE.findall(_read(todo.pop())):
            assert os.path.exists(os.path.join(_build.CSRC, inc)), \
                f"{src} includes missing {inc}"
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    assert "common.cuh" in seen


def test_the_check_catches_a_wrong_declaration():
    """A float declared as an int, a pointer cut to an int and a missing
    parameter each show as a mismatch; a stale declaration too."""
    text = ('extern "C" int sg_demo(const void* a, int n, float s,\n'
            '                       void* stream) {}')
    entries = parse_entries(text)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert mismatches(entries, {"sg_demo": [vp, i, f, vp]}) == []
    for wrong in ([vp, i, i, vp], [i, i, f, vp], [vp, i, f]):
        assert mismatches(entries, {"sg_demo": wrong}) == ["sg_demo"]
    assert mismatches(entries, {"sg_demo": [vp, i, f, vp],
                                "sg_gone": [vp]}) == ["sg_gone"]
