"""AprilTag family definitions (code tables + layout).

Copy of ``ccrs_tpu/detect/families.py`` (numpy only), the replacement for
the `aprilgrid` crate's `TagFamily` (reference call sites:
src/bin/camera_calibration.rs:31-33, src/data_loader.rs:43).  The code
tables are read by file path from the JAX package's
``ccrs_tpu/detect/data/tag_families.npz``; the port never imports
``ccrs_tpu``, whose package import pulls in the JAX framework.

Layout conventions:
- ``bits``: data grid is ``size x size`` cells (4/5/6).
- ``border``: black border width in cells.  Kalibr-style AprilGrid boards
  (EuRoC / TUM-VI) print tags with a 2-cell black border; classic AprilTag
  images use 1.  ``t36h11`` follows the Kalibr boards (the reference's
  default family detects EuRoC/TUM-VI), ``t36h11b1`` is the 1-cell-border
  variant of the same codes.
- Decoding matches against all 4 rotations; the matched rotation fixes the
  tag's canonical corner order (TL, TR, BR, BL in board frame, ids
  ``tag*4 + {0,1,2,3}``, reference src/board.rs:46-95).
"""

from __future__ import annotations

import dataclasses
import os
from functools import cached_property, lru_cache

import numpy as np

_DATA = os.path.join(
    os.path.dirname(__file__), "..", "..", "ccrs_tpu", "detect", "data",
    "tag_families.npz",
)

#: maximum hamming-distance correction per family (family "hN" = min dist N;
#: correct up to floor((N-1)/2) but stay conservative like apriltag defaults)
_MAX_HAMMING = {"t16h5": 0, "t25h7": 1, "t25h9": 1, "t36h11": 2, "t36h11b1": 2}

#: The reference CLI also lists t25h7 (bin/camera_calibration.rs:31-33).  Its
#: canonical 242-code table is not distributable here: it came from the
#: original AprilTag's non-reproducible randomized search (and OpenCV dropped
#: the family upstream), so a freshly generated lexicode table would NOT
#: decode real printed tag25h7 targets — strictly worse than refusing.  The
#: name is therefore NOT advertised; users with the table can construct a
#: ``TagFamily(name="t25h7", size=5, border=2, codes=..., max_hamming=1)``
#: and pass it to TagDetector directly.
FAMILY_NAMES = ["t16h5", "t25h9", "t36h11", "t36h11b1"]


@dataclasses.dataclass(frozen=True, eq=False)
class TagFamily:
    """A decoded tag family: codes plus geometry of the printed tag.

    Hash/eq by (name, size, border) so instances can key caches (the code
    table is immutable per family name).
    """

    name: str
    size: int  # data cells per side
    border: int  # black border cells
    codes: np.ndarray  # (n_codes, size*size) uint8, row-major bits, 1=white
    max_hamming: int

    def __hash__(self):
        return hash((self.name, self.size, self.border))

    def __eq__(self, other):
        return (
            isinstance(other, TagFamily)
            and (self.name, self.size, self.border)
            == (other.name, other.size, other.border)
        )

    @property
    def n_codes(self) -> int:
        return self.codes.shape[0]

    @property
    def total_size(self) -> int:
        """Cells per side including the black border."""
        return self.size + 2 * self.border

    @cached_property
    def rotated_codes(self) -> np.ndarray:
        """(n_codes * 4, size*size) int8 in {-1,+1}; rotation-major blocks.

        Row ``4*i + k`` is code ``i`` rotated k*90deg CW as seen by a
        detector sampling in canonical order.  Matching against this table
        with a +-1 bit vector turns hamming distance into a dot product
        (score = nbits - 2*hamming), i.e. one small matmul.
        """
        n, nb = self.codes.shape
        s = self.size
        out = np.zeros((n * 4, nb), np.int8)
        grid = self.codes.reshape(n, s, s)
        for k in range(4):
            rot = np.rot90(grid, k=k, axes=(1, 2)).reshape(n, nb)
            out[k::4] = (rot.astype(np.int16) * 2 - 1).astype(np.int8)
        return out


@lru_cache(maxsize=None)
def get_family(name: str) -> TagFamily:
    if name == "t25h7":
        raise ValueError(
            "t25h7's canonical code table cannot be generated offline (see "
            "FAMILY_NAMES note); construct a TagFamily with your own table "
            "and pass it to TagDetector instead."
        )
    if name not in FAMILY_NAMES:
        raise ValueError(f"unknown tag family {name!r}; expected one of {FAMILY_NAMES}")
    data = np.load(_DATA)
    base = "t36h11" if name == "t36h11b1" else name
    codes = data[f"{base}_codes"]
    size = int(data[f"{base}_size"])
    border = 1 if name == "t36h11b1" else 2
    return TagFamily(
        name=name,
        size=size,
        border=border,
        codes=codes,
        max_hamming=_MAX_HAMMING[name],
    )


_DEFAULT_SIZE = {"t16h5": 4, "t25h7": 5, "t25h9": 5, "t36h11": 6, "t36h11b1": 6}


def family_from_table(name: str, path: str) -> TagFamily:
    """Construct a TagFamily from a user-supplied code table (.npz).

    Closes the CLI parity gap for ``t25h7`` (the reference advertises it,
    ``src/bin/camera_calibration.rs:31-33``, but its
    canonical 242-code table is not reproducible offline — see the
    FAMILY_NAMES note): users who have the table supply it here via
    ``ccrs ... --tag-family t25h7 --tag-family-table table.npz``.

    npz keys:
      codes: REQUIRED — either (n, size*size) uint8 cell bits (1 = white,
        row-major, the layout ``tools/extract_tag_families.py`` emits) or
        (n,) unsigned packed codes with bit (size*size-1-i) holding cell i
        (the upstream apriltag ``codes[]`` convention).
      size: data cells per side (default from the family name).
      border: black border cells (default 2, Kalibr-style prints).
      max_hamming: decode correction budget (default 1).
    """
    data = np.load(path)
    if "codes" not in data:
        raise ValueError(f"{path}: missing 'codes' array")
    size = int(data["size"]) if "size" in data else _DEFAULT_SIZE.get(name, 6)
    nbits = size * size
    codes = np.asarray(data["codes"])
    if codes.ndim == 1:  # packed integers -> cell bits, MSB = cell 0
        codes = (
            (codes[:, None].astype(np.uint64) >> np.arange(nbits - 1, -1, -1, dtype=np.uint64))
            & np.uint64(1)
        ).astype(np.uint8)
    if codes.shape[1] != nbits:
        raise ValueError(
            f"{path}: codes have {codes.shape[1]} bits but size={size} "
            f"implies {nbits}"
        )
    return TagFamily(
        name=name,
        size=size,
        border=int(data["border"]) if "border" in data else 2,
        codes=codes.astype(np.uint8),
        max_hamming=int(data["max_hamming"]) if "max_hamming" in data else 1,
    )
