"""The benchmark's own DICOM writer: decimal strings, element layout."""

import struct

import pytest

from harness import dicomfile


@pytest.mark.parametrize("value", [-250.39, 0.98, 2.5, 1.5e-08, -183.45800000000003,
                                   123456789.123456789, 0.0, -0.001])
def test_decimal_strings_fit_and_read_back(value):
    s = dicomfile.ds(value)
    assert len(s) <= 16
    if len(repr(float(value))) <= 16:
        assert float(s) == float(value)
    else:
        assert abs(float(s) - value) <= abs(value) * 1e-13


def test_elements_have_even_lengths_and_nest():
    raw = dicomfile.dataset({
        0x00100010: ("PN", "Bench^Thorax"),
        0x00080018: ("UI", "1.2.3"),
        0x30060039: ("SQ", [{0x30060050: ("DS", [1.5, -2.25, 3.0])}]),
        0x7FE00010: ("OW", b"\1\2\3"),
    })
    pos, tags = 0, []
    while pos < len(raw):
        group, elem, vr = struct.unpack_from("<HH2s", raw, pos)
        vr = vr.decode()
        if vr in dicomfile.LONG_VRS:
            (n,) = struct.unpack_from("<I", raw, pos + 8)
            pos += 12
        else:
            (n,) = struct.unpack_from("<H", raw, pos + 6)
            pos += 8
        assert n % 2 == 0
        tags.append((group << 16) | elem)
        pos += n
    assert pos == len(raw)
    assert tags == sorted(tags)
    assert b"1.5\\-2.25\\3.0" in raw
