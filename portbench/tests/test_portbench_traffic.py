"""The generator: the same seed gives the same recordings,
another seed others; a clip cycle holds every frame count once."""

import json

import numpy as np
import pytest
import torch

from portbench.harness.traffic import Schedule, n_frames
from portbench.reference import room
from portbench.tests._support import REPO

CONFIG = json.loads((REPO / "portbench" / "configs" / "auxiva_ip_c2.json").read_text())
CLIPS = json.loads((REPO / "portbench" / "traffic" / "clips_varlen.json").read_text())
SONG = json.loads((REPO / "portbench" / "traffic" / "song_60s.json").read_text())
BIG = 2**31 + 12345


HOP = CONFIG["stft"]["hop_size"]


@pytest.mark.parametrize("fft_size, hop_size", [(CONFIG["stft"]["fft_size"], HOP), (4096, 2048)])
def test_frame_count_matches_the_program_stft(fft_size, hop_size):
    import audio_source_separation_tpu_torch as port

    for n in (32000, 32001, 34816, 191999, 192000):
        X = port.stft(np.zeros((1, n), np.float32), fft_size, hop_size, device="cpu")
        assert X.shape[-1] == n_frames(n, hop_size)


@pytest.mark.parametrize("traffic", [CLIPS, SONG])
def test_same_seed_same_schedule(traffic):
    a, b, c = Schedule(traffic, CONFIG, BIG), Schedule(traffic, CONFIG, BIG), Schedule(traffic, CONFIG, BIG + 1)
    first = [a.recording(i) for i in range(200)]
    assert first == [b.recording(i) for i in range(200)]
    if traffic is CLIPS:
        assert first != [c.recording(i) for i in range(200)]


def test_a_clip_cycle_holds_every_frame_count_once():
    s = Schedule(CLIPS, CONFIG, BIG)
    counts = s.frame_counts
    assert HOP == 1024 and counts[0] == n_frames(32000, HOP) == 33 and counts[-1] == n_frames(192000, HOP) == 189
    for cycle in range(3):
        lengths = [s.recording(cycle * len(counts) + k)[2] for k in range(len(counts))]
        assert all(32000 <= n <= 192000 for n in lengths)
        assert sorted(n_frames(n, HOP) for n in lengths) == counts
    for i in range(3 * len(counts)):
        entry, offset, length = s.recording(i)
        assert entry == i % CLIPS["pool"] and 0 <= offset <= s.longest - length


def test_two_seeds_ask_for_the_same_work():
    a, b = Schedule(CLIPS, CONFIG, BIG), Schedule(CLIPS, CONFIG, 7)
    n = len(a.frame_counts)
    frames = [sorted(n_frames(s.recording(i)[2], HOP) for i in range(n)) for s in (a, b)]
    assert frames[0] == frames[1]


def test_recordings_follow_the_seed():
    pool = room.recordings(2, 2, 8000, 16000, BIG, torch.device("cpu"))
    again = room.recordings(2, 2, 8000, 16000, BIG, torch.device("cpu"))
    other = room.recordings(2, 2, 8000, 16000, BIG + 1, torch.device("cpu"))
    assert all(np.array_equal(p, q) for p, q in zip(pool, again))
    assert not np.array_equal(pool[0], other[0])
    for x in pool:
        assert x.dtype == np.float32 and x.shape == (2, 8000) and x.flags["C_CONTIGUOUS"]
        assert np.abs(x).max() == pytest.approx(0.5, abs=1 / 32768)
        assert np.array_equal(np.round(x * 32768), x * 32768)  # 16-bit levels
        assert np.count_nonzero(x == 0) < x.size // 100


def test_a_clip_is_its_own_contiguous_array():
    s = Schedule(CLIPS, CONFIG, BIG)
    pool = [np.arange(2 * s.longest, dtype=np.float32).reshape(2, -1) for _ in range(CLIPS["pool"])]
    entry, offset, length = s.recording(5)
    x = s.mixture(pool, 5)
    assert x.flags["C_CONTIGUOUS"] and x.shape == (2, length)
    assert np.array_equal(x, pool[entry][:, offset : offset + length])
