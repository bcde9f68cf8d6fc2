"""The benchmark's own tests: the tiny checkout (``tiny.make_root``) maps
each of the benchmark's cells that a per-layer metric lists to the tiny
cells that stand in for it.  The Emu3 cell has a tiny cell of its own,
built by ``test_h100bench_emu3.py``, and none among the shared ones."""

from h100_bench.tests import tiny

tiny.STANDS_FOR.setdefault("emu3_720.spec8.deep", [])
