"""TIMIT phone-set mappings (Lee & Hon 60->48->39 folding); a copy of
``ctc_pytorch_tpu/data/prep/phones.py``.

The standard mapping table (the reference ships it as
``timit/conf/phones.60-48-39.map``; applied by
``timit/local/normalize_phone.py:13-45``).  Phones mapping to nothing
(glottal stop ``q``; silence-folded closures in 39) are dropped from
transcripts when their target is empty.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

# phone -> (48-set, 39-set); None = dropped at that level
PHONE_MAP_60_48_39: Dict[str, tuple] = {
    "aa": ("aa", "aa"), "ae": ("ae", "ae"), "ah": ("ah", "ah"),
    "ao": ("ao", "aa"), "aw": ("aw", "aw"), "ax": ("ax", "ah"),
    "ax-h": ("ax", "ah"), "axr": ("er", "er"), "ay": ("ay", "ay"),
    "b": ("b", "b"), "bcl": ("vcl", "sil"), "ch": ("ch", "ch"),
    "d": ("d", "d"), "dcl": ("vcl", "sil"), "dh": ("dh", "dh"),
    "dx": ("dx", "dx"), "eh": ("eh", "eh"), "el": ("el", "l"),
    "em": ("m", "m"), "en": ("en", "n"), "eng": ("ng", "ng"),
    "epi": ("epi", "sil"), "er": ("er", "er"), "ey": ("ey", "ey"),
    "f": ("f", "f"), "g": ("g", "g"), "gcl": ("vcl", "sil"),
    "h#": ("sil", "sil"), "hh": ("hh", "hh"), "hv": ("hh", "hh"),
    "ih": ("ih", "ih"), "ix": ("ix", "ih"), "iy": ("iy", "iy"),
    "jh": ("jh", "jh"), "k": ("k", "k"), "kcl": ("cl", "sil"),
    "l": ("l", "l"), "m": ("m", "m"), "n": ("n", "n"),
    "ng": ("ng", "ng"), "nx": ("n", "n"), "ow": ("ow", "ow"),
    "oy": ("oy", "oy"), "p": ("p", "p"), "pau": ("sil", "sil"),
    "pcl": ("cl", "sil"), "q": (None, None), "r": ("r", "r"),
    "s": ("s", "s"), "sh": ("sh", "sh"), "t": ("t", "t"),
    "tcl": ("cl", "sil"), "th": ("th", "th"), "uh": ("uh", "uh"),
    "uw": ("uw", "uw"), "ux": ("uw", "uw"), "v": ("v", "v"),
    "w": ("w", "w"), "y": ("y", "y"), "z": ("z", "z"),
    "zh": ("zh", "sh"),
}


def phone_map(to: str) -> Dict[str, str]:
    """Build the mapping used by ``normalize_phone.py --to {60-48,60-39,48-39}``.

    Dropped phones map to "" (then filtered), matching the reference.
    """
    out: Dict[str, str] = {}
    if to == "60-48":
        for p, (p48, _) in PHONE_MAP_60_48_39.items():
            out[p] = p48 or ""
    elif to == "60-39":
        for p, (_, p39) in PHONE_MAP_60_48_39.items():
            out[p] = p39 or ""
    elif to == "48-39":
        for p, (p48, p39) in PHONE_MAP_60_48_39.items():
            if p48 is not None:
                out[p48] = p39 or ""
    else:
        raise ValueError(f"unsupported mapping {to!r}")
    return out


def normalize_phones(phones: Iterable[str], to: str) -> List[str]:
    m = phone_map(to)
    return [m[p] for p in phones if m[p] != ""]
