"""The traced run's arithmetic that needs no card: idle gaps labelled by
the host spans open at them, and the traffic's size multisets."""

import numpy as np

from h100_bench import harness
from h100_bench.drivers.engine_window import spread_sizes


def test_idle_gaps_by_open_spans():
    spans = [("forward", 1.0, 2.0), ("step", 0.5, 3.0), ("slot_status",
                                                          3.0, 3.5),
             ("call", 0.0, 10.0)]
    gaps = [(0.6, 0.8), (1.2, 1.4), (2.5, 2.9), (3.1, 3.3), (11.0, 12.0)]
    out = harness.label_gaps(spans, gaps)
    want = {"call>step": 0.6, "call>step>forward": 0.2,
            "call>slot_status": 0.2, "host": 1.0}
    assert set(out) == set(want)
    assert all(abs(out[k] - v) < 1e-9 for k, v in want.items())


def test_every_seed_serves_the_same_sizes():
    a = spread_sizes(np.random.default_rng(1), 24, 8, 32, 8)
    b = spread_sizes(np.random.default_rng(2), 24, 8, 32, 8)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert sorted(a[:8]) == [8, 11, 15, 18, 22, 25, 29, 32]
