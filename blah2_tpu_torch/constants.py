"""Physical constants.

Parity: reference `src/data/meta/Constants.h:13` defines c = 299792458.
"""

SPEED_OF_LIGHT: float = 299792458.0
