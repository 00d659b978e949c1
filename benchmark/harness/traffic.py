"""The one generator of the benchmark's traffic: a mix file of parameters
(benchmark/traffic/<name>.json) and the seed give the stream its
sequences.

A mix holds: `lengths` (the frame counts of the sequences the stream runs
back to back: every seed runs the same multiset in its own seeded order,
cycled), `entry_min`, `entry_max` (the frames of its first sequence
between which the stream enters the window; the frames before it run in
set-up and cover every shape the window meets) and `check_ordinals` (the
range of window frames from which the frames the check reads are
drawn)."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

FRAMES_PER_STREAM = 4000  # more than the stream completes in one window


class StreamPlan(NamedTuple):
    lengths: List[int]      # sequence lengths, in order
    seq_seeds: List[int]    # the seed of each sequence's BATrack (its patch draws)
    scene_seed: int         # the stream's frames
    entry: int              # window entry frame of the first sequence
    ordinals: tuple         # (append, update) window ordinals the check starts from


def plan_stream(mix: dict, seed: int) -> StreamPlan:
    rng = np.random.default_rng([seed, 0])
    lengths: List[int] = []
    while sum(lengths) < FRAMES_PER_STREAM:
        lengths += [int(x) for x in rng.permutation(mix["lengths"])]
    seq_seeds = [int(x) for x in rng.integers(0, 2 ** 62, len(lengths))]
    entry = int(rng.integers(mix["entry_min"], min(mix["entry_max"], lengths[0] - 2) + 1))
    lo, hi = mix["check_ordinals"]
    ordinals = tuple(int(x) for x in rng.integers(lo, hi, 2))
    return StreamPlan(lengths, seq_seeds, int(rng.integers(0, 2 ** 62)), entry, ordinals)
