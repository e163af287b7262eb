# Copied from medicalimageanalysis_tpu/dicom/dataset.py.
"""Dataset / DataElement / Sequence — the in-memory DICOM object model.

Own implementation replacing pydicom's Dataset for this framework. It keeps
the access idioms the reference code relies on (reference read/dicom.py):

- ``ds.PixelSpacing``                    keyword attribute access
- ``ds['ImageOrientationPatient'].value``  element access by keyword
- ``(0x0028, 0x1052) in ds`` / ``'PixelSpacing' in ds``
- ``ds.pixel_array``                     decoded numpy array
- ``del ds.PixelData``                   free pixel memory
- sequences index like lists of Datasets
"""

from __future__ import annotations

from .dictionary import keyword_to_tag, tag_to_keyword, tag_to_vr

_BINARY_VRS = {"OB", "OW", "OF", "OD", "OL", "UN"}
_INT_VRS = {"US", "UL", "SS", "SL", "SV", "UV"}
_FLOAT_VRS = {"FL", "FD"}


def _normalize_tag(key):
    """Accept (group, elem) tuples, ints, or keyword strings -> int tag."""
    if type(key) is int:  # hot path: exact type check beats isinstance
        return key
    if isinstance(key, tuple):
        return (key[0] << 16) | key[1]
    if isinstance(key, int):
        return key
    if isinstance(key, str):
        tag = keyword_to_tag(key)
        if tag is None:
            raise KeyError(f"unknown DICOM keyword {key!r}")
        return tag
    raise TypeError(f"invalid tag key {key!r}")


def value_or(ds, key, default):
    """Element value, or `default` when the tag is absent OR its value
    decoded to None (corrupt DS/IS numeric strings decode to None
    rather than raising — fuzz finding; a bare presence check would
    pass None into float()/np.double() at the consumer)."""
    if key not in ds:
        return default
    v = ds[key].value
    return default if v is None else v


class DataElement:
    __slots__ = ("tag", "VR", "value")

    def __init__(self, tag, vr, value):
        self.tag = tag
        self.VR = vr
        self.value = value

    @property
    def keyword(self):
        return tag_to_keyword(self.tag)

    # the reference indexes elements directly (e.g. DetectorElementSpacing[1])
    def __getitem__(self, idx):
        return self.value[idx]

    def __len__(self):
        try:
            return len(self.value)
        except TypeError:
            return 1

    def __iter__(self):
        return iter(self.value)

    def __repr__(self):
        kw = self.keyword or "?"
        return (f"({self.tag >> 16:04X},{self.tag & 0xFFFF:04X}) "
                f"{self.VR} {kw}: {self.value!r}")


class Sequence(list):
    """A list of Datasets (SQ value)."""


class Dataset:
    """Mutable tag->element mapping with keyword attribute sugar."""

    def __init__(self):
        object.__setattr__(self, "_dict", {})
        object.__setattr__(self, "filename", None)
        object.__setattr__(self, "file_meta", None)
        object.__setattr__(self, "_pixel_source", None)  # lazy decode closure
        object.__setattr__(self, "_pixel_cache", None)

    # ---- mapping protocol ----
    def __contains__(self, key):
        try:
            return _normalize_tag(key) in self._dict
        except KeyError:
            return False

    def __getitem__(self, key):
        return self._dict[_normalize_tag(key)]

    def __setitem__(self, key, element):
        self._dict[_normalize_tag(key)] = element

    def __delitem__(self, key):
        del self._dict[_normalize_tag(key)]

    def __iter__(self):
        return iter(sorted(self._dict))

    def __len__(self):
        return len(self._dict)

    def elements(self):
        for tag in sorted(self._dict):
            yield self._dict[tag]

    def keys(self):
        return sorted(self._dict)

    # ---- attribute (keyword) protocol ----
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        tag = keyword_to_tag(name)
        if tag is None or tag not in self._dict:
            raise AttributeError(f"Dataset has no element {name!r}")
        return self._dict[tag].value

    def __setattr__(self, name, value):
        if name in ("filename", "file_meta", "_pixel_source", "_pixel_cache"):
            object.__setattr__(self, name, value)
            return
        tag = keyword_to_tag(name)
        if tag is None:
            object.__setattr__(self, name, value)
            return
        vr = tag_to_vr(tag)
        self._dict[tag] = DataElement(tag, vr, value)
        if name == "PixelData":
            object.__setattr__(self, "_pixel_cache", None)
            object.__setattr__(self, "_pixel_source", None)

    def __delattr__(self, name):
        tag = keyword_to_tag(name)
        if tag is not None and tag in self._dict:
            del self._dict[tag]
            if name == "PixelData":
                object.__setattr__(self, "_pixel_cache", None)
                object.__setattr__(self, "_pixel_source", None)
        else:
            object.__delattr__(self, name)

    def get(self, key, default=None):
        try:
            tag = _normalize_tag(key)
        except (KeyError, TypeError):
            return default
        el = self._dict.get(tag)
        return el.value if el is not None else default

    def add(self, tag, vr, value):
        tag = _normalize_tag(tag)
        self._dict[tag] = DataElement(tag, vr, value)

    # ---- pixels ----
    @property
    def pixel_array(self):
        """Decode PixelData into a numpy array (cached)."""
        if self._pixel_cache is not None:
            return self._pixel_cache
        from .pixels import decode_pixel_data
        arr = decode_pixel_data(self)
        object.__setattr__(self, "_pixel_cache", arr)
        return arr

    def __repr__(self):
        lines = []
        for el in self.elements():
            if isinstance(el.value, Sequence):
                lines.append(f"{el.keyword or el.tag:>34}: SQ x{len(el.value)}")
            elif isinstance(el.value, (bytes, bytearray)):
                lines.append(f"{el.keyword or el.tag:>34}: <{len(el.value)} bytes>")
            else:
                lines.append(f"{el.keyword or el.tag:>34}: {el.value!r}")
        return "\n".join(lines)


class FileMetaDataset(Dataset):
    pass
