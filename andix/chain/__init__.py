"""Anchor chaining: replay of the reference's dist_anchor scan.

The reference's per-pair loop (``dist_anchor``, src/process.c:141-214) is
path-dependent: the visited query positions depend on previously accepted
anchors (skip advance ``pos_Q += length + 1``), and "lucky" anchors
(src/process.c:82-100) substitute a diagonal extension for the full search.
This cannot be a data-parallel map — but it does not need the ESA either:
given precomputed per-position match statistics (the device part), the replay
touches only O(#anchors) positions.  ``replay_py`` is the exact-semantics
Python implementation (oracle); the native C++ implementation in
``andix.native`` is the production host runtime.
"""

from .replay_py import dist_anchor_replay  # noqa: F401
