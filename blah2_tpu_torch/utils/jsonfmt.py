"""JSON formatting helpers matching the reference wire format.

The reference serializes every product with rapidjson and
``writer.SetMaxDecimalPlaces(2)`` (e.g. `src/data/Map.cpp:158`,
`src/data/Detection.cpp:79`), i.e. floats carry at most two decimal places.
We reproduce that by rounding floats to 2 decimals before ``json.dumps``.

`append_json_array` reproduces the append-to-JSON-array file persistence of
`Map::save` / `Detection::save` / `Timing::save` (`src/data/Map.cpp:209-262`):
the file is a single growing JSON array; each record replaces the trailing
``]`` with ``,<record>]``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any


def round2(value: float) -> float:
    """Round to at most 2 decimal places (rapidjson SetMaxDecimalPlaces(2))."""
    if isinstance(value, float):
        if math.isnan(value) or math.isinf(value):
            return 0.0
        return round(value, 2)
    return value


def _convert(obj: Any) -> Any:
    if isinstance(obj, float):
        return round2(obj)
    if isinstance(obj, dict):
        return {k: _convert(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert(v) for v in obj]
    # numpy scalars
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        return _convert(obj.item())
    return obj


def dumps(obj: Any) -> str:
    """Serialize with 2-decimal float precision, compact separators."""
    return json.dumps(_convert(obj), separators=(",", ":"), allow_nan=False)


def append_json_array(json_str: str, path: str) -> bool:
    """Append one JSON record to a JSON-array file, creating it if missing."""
    try:
        if not os.path.exists(path):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                f.write("[]")
        with open(path, "rb+") as f:
            f.seek(0)
            if f.read(1) != b"[":
                return False
            is_empty = f.read(1) == b"]"
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"]":
                return False
            f.seek(-1, os.SEEK_END)
            payload = (b"" if is_empty else b",") + json_str.encode() + b"]"
            f.write(payload)
        return True
    except OSError:
        return False
