"""Search-procedure constants (counterpart of ``repro.core.search``).

The bounded and standalone search procedures are not ported yet; the
sentinel they share is, so every module compares against it by name.
"""

#: predecessor rank of a query below the table's smallest key
NO_PRED = -1
