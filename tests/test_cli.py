"""CLI: argument parsing, reference-style roundtrip, waterfall smoke."""
import json

import numpy as np
import pytest

from myldpccppapi.cli import _parse_snr_grid, build_parser, main


def test_snr_grid_parsing():
    assert _parse_snr_grid("1:3:0.5") == [1.0, 1.5, 2.0, 2.5, 3.0]
    assert _parse_snr_grid("2,4") == [2.0, 4.0]
    assert _parse_snr_grid("0:4") == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_parser_rejects_bad_algo(capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["test", "432", "8", "5.0", "BOGUS"])


def test_roundtrip_cpu_golden(capsys):
    """Reference-style self-test through the native golden decoder: clean
    channel at 7 dB must decode with ErrNum=0."""
    rc = main(["test", "432", "8", "7.0", "CPU"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "ErrNum=0" in out
    assert "ThroughPut=" in out


def test_roundtrip_tdmp(capsys):
    rc = main(["test", "432", "8", "7.0", "TDMP"])
    out = capsys.readouterr().out
    assert rc == 0 and "ErrNum=0" in out


def test_waterfall_smoke(tmp_path, capsys):
    out_csv = tmp_path / "wf.csv"
    ck = tmp_path / "ck.json"
    rc = main([
        "waterfall", "--family", "wimax", "--n", "576", "--rate", "1/2",
        "--snr", "5", "--batch", "16", "--target-errors", "1",
        "--max-frames", "32", "--checkpoint", str(ck), "--out", str(out_csv),
    ])
    assert rc == 0
    assert out_csv.exists() and ck.exists()
    lines = out_csv.read_text().strip().split("\n")
    assert len(lines) == 2 and lines[0].startswith("snr_db,")
    state = json.loads(ck.read_text())
    assert state["points"][0]["frames"] >= 16


def test_waterfall_snr_shards(tmp_path):
    """--snr-shards runs SNR points simultaneously on an (snr x data) mesh
    (the conftest provides 8 virtual CPU devices)."""
    out_csv = tmp_path / "wf_shards.csv"
    rc = main([
        "waterfall", "--family", "wimax", "--n", "576", "--rate", "1/2",
        "--snr", "4,5", "--batch", "8", "--target-errors", "1",
        "--max-frames", "16", "--snr-shards", "2", "--out", str(out_csv),
    ])
    assert rc == 0
    lines = out_csv.read_text().strip().split("\n")
    assert len(lines) == 3
    # both points simulated the full budget (clean at 4-5 dB)
    for row in lines[1:]:
        assert int(row.split(",")[1]) >= 16


def test_waterfall_snr_shards_must_divide():
    with pytest.raises(SystemExit):
        main([
            "waterfall", "--family", "wimax", "--snr", "4,5",
            "--batch", "8", "--max-frames", "8", "--snr-shards", "3",
        ])


def test_waterfall_rejects_crc_plus_bch():
    with pytest.raises(SystemExit):
        main([
            "waterfall", "--family", "dvbs2", "--n", "16200", "--rate", "1/2",
            "--crc", "16", "--bch", "--snr", "3", "--batch", "8",
            "--max-frames", "8",
        ])


def test_threshold_subcommand(capsys):
    rc = main(["threshold", "--family", "wimax", "--n", "576",
               "--rate", "1/2"])
    out = capsys.readouterr().out
    assert rc == 0
    thr = float(out.split("threshold_ebn0_db=")[1].splitlines()[0])
    assert 0.5 < thr < 1.2
    assert "threshold_sigma=" in out


def test_design_subcommand(tmp_path, capsys):
    out = tmp_path / "addrs.txt"
    rc = main(["design", "--family", "dvbs2", "--n", "16200",
               "--rate", "1/2", "--steps", "10", "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "designed threshold:" in text
    # the saved table loads back as a valid code
    from myldpccppapi.codes.dvbs2 import dvbs2, parse_address_table

    code = dvbs2(16200, "1/2", addresses=parse_address_table(out.read_text()))
    assert code.n == 16200


def test_probe_subcommand(capsys):
    rc = main(["probe", "--family", "wimax", "--n", "576", "--rate", "1/2",
               "--max-pairs", "64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "breaches=" in out and "probes=" in out
