"""The benchmark's own tests (CPU; the ``cuda`` ones skip without a card):

    python -m pytest portbench/tests -q

They import the port only where they compare with it or drive it on the
host at a tiny size; nothing here imports JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
