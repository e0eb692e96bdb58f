"""Waterfall campaign: stopping criteria, checkpoint/resume, reporting."""
import json

import numpy as np
import pytest

from myldpccppapi.campaign import CampaignConfig, PointStats, WaterfallCampaign
from myldpccppapi.parallel.sim import SimStats


def _fake_step(fer_by_snr):
    """Deterministic fake step_fn: 100 frames/step, fer*100 errors each."""

    def step(seed, snr_db):
        fer = fer_by_snr[float(snr_db)]
        frames = 100
        fe = int(round(fer * frames))
        return SimStats(
            frames=np.int64(frames),
            frame_errors=np.int64(fe),
            bit_errors=np.int64(fe * 3),
            info_bits=np.int64(frames * 432),
            iterations=np.int64(frames * 5),
            unconverged=np.int64(fe),
        )

    return step


def test_stops_on_frame_errors():
    cfg = CampaignConfig(snr_db=[1.0, 5.0], min_frame_errors=50, max_frames=10_000)
    camp = WaterfallCampaign(
        cfg, _fake_step({1.0: 0.5, 5.0: 0.0}), frames_per_step=100
    )
    pts = camp.run()
    # noisy point: 50 errors after 1 step; clean point: runs to max_frames
    assert pts[0].frame_errors >= 50 and pts[0].frames == 100
    assert pts[1].frames == 10_000 and pts[1].frame_errors == 0
    assert pts[0].fer == pytest.approx(0.5)
    assert pts[1].ber == 0.0


def test_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.json")
    cfg = CampaignConfig(snr_db=[2.0], min_frame_errors=40, max_frames=1_000)
    step = _fake_step({2.0: 0.1})
    c1 = WaterfallCampaign(cfg, step, 100, fingerprint="fp1", checkpoint_path=ck)
    # run two steps manually then checkpoint
    c1.points[0].frames = 200
    c1.points[0].frame_errors = 20
    c1.steps_done[0] = 2
    c1.save()
    c2 = WaterfallCampaign(cfg, step, 100, fingerprint="fp1", checkpoint_path=ck)
    assert c2.points[0].frames == 200 and c2.steps_done[0] == 2
    pts = c2.run()
    # resumes from 200 frames / 20 errors: needs 2 more steps to reach 40
    assert pts[0].frame_errors == 40 and pts[0].frames == 400
    # a different fingerprint must NOT resume
    c3 = WaterfallCampaign(cfg, step, 100, fingerprint="other", checkpoint_path=ck)
    assert c3.points[0].frames == 0


def test_report_and_csv(tmp_path):
    cfg = CampaignConfig(snr_db=[1.0], min_frame_errors=10, max_frames=100)
    camp = WaterfallCampaign(cfg, _fake_step({1.0: 0.2}), 100)
    camp.run()
    rep = camp.report()
    assert rep["points"][0]["fer"] == pytest.approx(0.2)
    p = tmp_path / "out.csv"
    camp.write_csv(str(p))
    lines = p.read_text().strip().split("\n")
    assert len(lines) == 2 and lines[0].startswith("snr_db,")


def test_ci95():
    p = PointStats(1.0, frames=10_000, frame_errors=100)
    assert 0.001 < p.fer_ci95() < 0.01


def _fake_group_step(fer_by_snr, group):
    """Grouped fake step: stats arrays with a leading [group] axis."""

    def step(seed, snrs):
        assert isinstance(snrs, list) and len(snrs) == group
        fes = np.array([int(round(fer_by_snr[float(s)] * 100)) for s in snrs],
                       dtype=np.int64)
        ones = np.full(group, 100, dtype=np.int64)
        return SimStats(
            frames=ones, frame_errors=fes, bit_errors=fes * 3,
            info_bits=ones * 432, iterations=ones * 5, unconverged=fes,
            undetected_errors=np.zeros(group, np.int64),
            crc_rejected=np.zeros(group, np.int64),
        )

    return step


def test_grouped_snr_stepping(tmp_path):
    """snr_group_size > 1: groups of SNR points step together (the
    snr-sharded mesh layout); per-point stopping still honored, finished
    points run as discarded filler, checkpoint resume works."""
    fers = {1.0: 0.5, 2.0: 0.1, 3.0: 0.0, 4.0: 0.0}
    cfg = CampaignConfig(snr_db=[1.0, 2.0, 3.0, 4.0], min_frame_errors=50,
                         max_frames=500)
    ck = str(tmp_path / "g.json")
    camp = WaterfallCampaign(cfg, _fake_group_step(fers, 2), 100,
                             fingerprint="g", checkpoint_path=ck,
                             snr_group_size=2)
    pts = camp.run()
    # point 1.0 stops at 50 errors (1 step); 2.0 runs to 500 frames in the
    # same group; 3.0/4.0 run to max_frames
    assert pts[0].frame_errors == 50 and pts[0].frames == 100
    assert pts[1].frames == 500 and pts[1].frame_errors == 50
    assert pts[2].frames == 500 and pts[3].frames == 500
    # group seeds stay aligned: finished member advanced its step counter
    assert camp.steps_done[0] == camp.steps_done[1]
    # resume is a no-op once finished
    camp2 = WaterfallCampaign(cfg, _fake_group_step(fers, 2), 100,
                              fingerprint="g", checkpoint_path=ck,
                              snr_group_size=2)
    assert camp2.finished


def test_grouped_tail_padding():
    """A grid not divisible by the group size pads the last group by
    repeating its last point; padded results are discarded."""
    fers = {1.0: 0.0, 2.0: 0.0, 3.0: 0.0}
    cfg = CampaignConfig(snr_db=[1.0, 2.0, 3.0], min_frame_errors=10,
                         max_frames=200)
    camp = WaterfallCampaign(cfg, _fake_group_step(fers, 2), 100,
                             snr_group_size=2)
    pts = camp.run()
    assert all(p.frames == 200 for p in pts)


def test_grouped_accumulate_scalar_default_fields():
    """A grouped step_fn whose stats carry the SCALAR SimStats defaults for
    the split fields (np.int64(0), no leading group axis) must accumulate
    without error (regression: np.asarray(0)[pos] raised IndexError)."""
    def step(seed, snrs):
        g = len(snrs)
        ones = np.full(g, 100, dtype=np.int64)
        return SimStats(frames=ones, frame_errors=np.zeros(g, np.int64),
                        bit_errors=np.zeros(g, np.int64),
                        info_bits=ones * 432, iterations=ones * 5,
                        unconverged=np.zeros(g, np.int64))
        # undetected_errors / crc_rejected fall back to the scalar defaults

    cfg = CampaignConfig(snr_db=[1.0, 2.0], min_frame_errors=1,
                         max_frames=200)
    camp = WaterfallCampaign(cfg, step, 100, snr_group_size=2)
    pts = camp.run()
    assert all(p.frames == 200 for p in pts)
    assert all(p.undetected_errors == 0 for p in pts)
