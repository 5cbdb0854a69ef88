"""IO tests: alignment parsing/encoding/pattern compression + config codec
+ timing utils."""

import numpy as np
import pytest

from plf_tpu.config import AieType, Backend, Layout, PLFConfig
from plf_tpu.io.alignment import (Alignment, compress_patterns, encode_dna,
                                  encode_protein, parse_fasta, parse_phylip)
from plf_tpu.utils.timing import (TimingData, bandwidth_As, bandwidth_MBs,
                                  format_timing_table, write_csv)


FASTA = """\
>seq1 description here
ACGT-ACGT
ACGT
>seq2
TGCA-TGCAN
ACG
"""


def test_parse_fasta_multiline():
    names, seqs = parse_fasta(FASTA)
    assert names == ["seq1", "seq2"]
    assert seqs[0] == "ACGT-ACGTACGT"
    assert len(seqs[1]) == 13


def test_parse_phylip():
    text = "2 8\ntaxonA ACGTACGT\ntaxonB TTTTACGT\n"
    names, seqs = parse_phylip(text)
    assert names == ["taxonA", "taxonB"]
    assert seqs == ["ACGTACGT", "TTTTACGT"]


def test_encode_dna_ambiguity():
    # IUPAC partial ambiguity keeps its information (R -> code 4,
    # Y -> 5, multi-hot tip CLVs); only N/gap/? are fully ambiguous
    codes = encode_dna(["ACGTUacgt-NRY?"])
    expect = [0, 1, 2, 3, 3, 0, 1, 2, 3, -1, -1, 4, 5, -1]
    np.testing.assert_array_equal(codes[0], expect)


def test_encode_protein():
    codes = encode_protein(["ARNDV", "wyv-X"])
    assert codes[0, 0] == 0 and codes[0, 4] == 19
    assert codes[1, 3] == -1 and codes[1, 4] == -1


def test_compress_patterns_weights_sum():
    rng = np.random.default_rng(40)
    codes = rng.integers(0, 4, size=(5, 100)).astype(np.int8)
    codes[:, 50:] = codes[:, :50]  # duplicate half the columns
    pats, wgt = compress_patterns(codes)
    assert pats.shape[1] <= 50
    assert wgt.sum() == 100
    # Reconstruction: every original column appears among patterns.
    pat_set = {tuple(c) for c in pats.T}
    for col in codes.T:
        assert tuple(col) in pat_set


def test_compress_patterns_likelihood_invariant():
    """Pattern compression must not change the tree log-likelihood."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.models import PhyloModel, jc69, random_tree
    rng = np.random.default_rng(41)
    tips = rng.integers(0, 4, size=(5, 64)).astype(np.int8)
    tips[:, 32:] = tips[:, :32]
    tree = random_tree(5, seed=2)
    cfg = PLFConfig(block_sites=128, interpret=True)
    full = PhyloModel(tree, jc69(), tips, config=cfg).log_likelihood()
    pats, wgt = compress_patterns(tips)
    comp = PhyloModel(tree, jc69(), pats, wgt=wgt,
                      config=cfg).log_likelihood()
    assert abs(full.log_likelihood - comp.log_likelihood) < 1e-6 * abs(
        full.log_likelihood) + 1e-6


def test_alignment_reorder():
    a = Alignment(["b", "a"], np.array([[1, 2], [3, 0]], np.int8))
    r = a.reorder(["a", "b"])
    np.testing.assert_array_equal(r.codes, [[3, 0], [1, 2]])


# ------------------------------------------------------------- config ------

def test_config_name_roundtrip():
    cfg = PLFConfig(states=4, block_sites=2048, instances=9,
                    layout=Layout.COMBINED, aie_type=AieType.WINDOW)
    name = cfg.to_name()
    back = PLFConfig.from_name(name)
    assert back.block_sites == 2048
    assert back.instances == 9
    assert back.layout is Layout.COMBINED
    assert back.aie_type is AieType.WINDOW


def test_config_parses_reference_style_names():
    """Names shaped like the reference xclbins decode the same way the
    reference host does (include.h:44-75)."""
    cfg = PLFConfig.from_name("plf_mem4DNAwindowComb_128x9DNAwindow8192Comb")
    assert cfg.aie_type is AieType.WINDOW
    # 8192-byte window = 512 sites -> rounded to lane multiple
    assert cfg.block_sites == 512
    assert cfg.instances == 9
    cfg2 = PLFConfig.from_name("plf_mem4DNAstream2in_128x4DNAstream")
    assert cfg2.aie_type is AieType.STREAM
    assert cfg2.layout is Layout.SEPARATE


def test_config_validation():
    with pytest.raises(ValueError):
        PLFConfig(block_sites=100)
    with pytest.raises(ValueError):
        PLFConfig(states=1)
    with pytest.raises(ValueError):
        PLFConfig(dtype="int8")


# ------------------------------------------------------------- timing ------

def test_timing_phases_and_csv(tmp_path):
    d = TimingData()
    d.record(0.0, 1.0, 3.0, 3.5)
    d.record(3.5, 4.0, 7.0, 8.0)
    assert d.hm() == pytest.approx(1.5)
    assert d.msm() == pytest.approx(5.0)
    assert d.mh() == pytest.approx(1.5)
    assert d.total() == pytest.approx(8.0)
    assert d.max_msm() == pytest.approx(3.0)
    assert bandwidth_MBs(1000.0, 1e9) == pytest.approx(1000.0)
    assert bandwidth_As(2000.0, 1e6) == pytest.approx(5e5)
    table = format_timing_table(d, 1e9, 10**6, reference_ms=100.0)
    assert "Total execution time" in table
    p = tmp_path / "t.csv"
    write_csv(str(p), {"i0": d})
    lines = p.read_text().splitlines()
    assert lines[0] == "hm_i0,msm_i0,mh_i0"
    assert len(lines) == 3


def test_engine_geometry_and_describe():
    from plf_tpu import PLFEngine, PLFConfig
    eng = PLFEngine(PLFConfig(block_sites=1024))
    g = eng.geometry(10_000, plf_calls=3)
    p = g["per_call"]
    assert p["sites_padded"] == 10240
    assert p["padding"] == 240
    assert p["clv_bytes"] == 16 * 4 * 10240
    assert p["blocks"] == 10
    table = eng.describe(10_000, plf_calls=3)
    assert "alignment sites" in table and "10000" in table


def test_profiling_utils():
    from plf_tpu.utils.profiling import PhaseProfiler, throughput_report
    prof = PhaseProfiler()
    with prof.range("work"):
        pass
    rep = prof.report()
    assert "work" in rep
    s = throughput_report(10**9, 0.5, device_kind="NVIDIA H100 80GB HBM3")
    assert "Gsites/s" in s and "roofline" in s and "3350 GB/s" in s
    with pytest.raises(ValueError, match="no published peaks"):
        throughput_report(10**9, 0.5, device_kind="cpu")


def test_cli_host_mem_equivalent(tmp_path):
    """python -m plf_tpu end-to-end: report, run, verify, timing, CSV."""
    from plf_tpu.__main__ import main
    csv_path = str(tmp_path / "runs.csv")
    rc = main(["--sites", "600", "--calls", "2", "--csv", csv_path])
    assert rc == 0
    lines = open(csv_path).read().splitlines()
    assert lines[0] == "hm_i0,msm_i0,mh_i0"
    assert len(lines) == 3


def test_engine_bfloat16_fast_mode():
    # cfg.dtype="bfloat16" runs the CLV stream in bf16 (fast mode): the
    # output is bf16 and tracks the fp32 golden within bf16 precision
    import jax.numpy as jnp

    from plf_tpu import PLFConfig, PLFEngine
    from plf_tpu.reference import plf_reference

    rng = np.random.default_rng(11)
    n = 512
    x1 = rng.random((n, 16), np.float32)
    x2 = rng.random((n, 16), np.float32)
    left = rng.random((4, 4, 4), np.float32)
    right = rng.random((4, 4, 4), np.float32)
    ev = rng.random((4, 4), np.float32)
    eng = PLFEngine(PLFConfig(dtype="bfloat16", block_sites=128,
                              interpret=True))
    out = eng.plf(x1, x2, left, right, ev)
    assert out.x3.dtype == jnp.bfloat16
    g3, _, gsi = plf_reference(x1, x2, left, right, ev,
                               np.ones(n, np.int32))
    got = np.asarray(out.x3, np.float32).reshape(g3.shape)
    np.testing.assert_allclose(got, g3, rtol=3e-2, atol=1e-3)
    assert int(out.scaler_increment) == int(gsi)
