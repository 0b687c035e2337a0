"""Staining-type registry: observation/staining symbols -> NDPI filename
patterns and numbered data directories.

The port's own copy of ``glomeruli_segmentation_tpu/utils/glomus_handler.py``
(the port imports nothing of the JAX package); a test holds the two equal.
"""
from __future__ import annotations

import re


class GlomusHandlerException(Exception):
    pass


_PATTERNS = {
    "OPT_PAM": r".*PAM.*\.ndpi",
    "OPT_MT": r".*MT.*\.ndpi",
    "OPT_PAS": r".*PAS.*\.ndpi",
    "OPT_HE": r".*HE.*\.ndpi|.*\d+ - \d+.*\.ndpi|.*\d+-\d*\.ndpi",
    "OPT_Azan": r".*Azan.*\.ndpi",
}

_STAINING_DIRS = {
    "OPT_PAS": "02_PAS",
    "OPT_PAM": "03_PAM",
    "OPT_MT": "05_MT",
    "OPT_Azan": "06_Azan",
}

class GlomusHandler:
    def set_type(self, data_category: str) -> None:
        if data_category not in _PATTERNS:
            raise GlomusHandlerException(
                "Unknown Argument is given.:" + data_category)
        self.TYPE = data_category
        self.pattern = _PATTERNS[data_category]
        self.repattern = re.compile(self.pattern, re.IGNORECASE)

    @staticmethod
    def get_staining_type(staining_type: str) -> str:
        return _STAINING_DIRS.get(staining_type, "")
