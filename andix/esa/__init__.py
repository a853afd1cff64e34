"""Enhanced-suffix-array subsystem, redesigned for an accelerator.

The reference builds one ESA per subject with libdivsufsort + sequential
Φ-LCP + child table + 10-mer cache (``src/esa.c``), then walks it once per
query position.  Here the same capability — longest-match length, uniqueness,
and subject position for every query position — is produced by:

* a *joint* (generalized) suffix array over subject strings and query
  strings together, built by prefix-doubling rank sorts (``doubling``);
* adjacent-LCP computation (``lcp``);
* per-subject segmented min-scans over the joint SA order that yield matching
  statistics for all query positions at once (``matchstats``).

This replaces the irregular per-character tree descent
(``get_match_cached``/``get_interval``, src/esa.c:441-656) with large sorts
and scans that map onto wide data-parallel hardware.
"""
