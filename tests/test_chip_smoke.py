"""chip_smoke.py's phases at tiny sizes on the CPU backend, and its
refusal to report anything without a GPU.  The GPU-marked test runs the
ops phase on the card (skips elsewhere)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ok_lines(text: str):
    return [ln for ln in text.splitlines() if '"ok"' in ln]


@pytest.fixture(scope="module")
def tiny_golden():
    """A 666-read, 2-read-group dataset and the oracle's qualities."""
    from kbbq_tpu.io.batcher import ReadArrays
    from kbbq_tpu.oracle import OracleConfig, recalibrate_reads
    from kbbq_tpu.oracle.pipeline import ReadBatch
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.utils.synth import make_dataset

    ds = make_dataset(genome_len=2000, read_len=60, coverage=20.0,
                      error_rate=0.01, seed=5, num_rg=2, paired=True,
                      n_rate=0.005)
    nq, _ = recalibrate_reads(
        ReadBatch(ds.codes, ds.quals, ds.rgs, ds.seconds),
        OracleConfig(k=16, coverage=20.0))
    want = np.stack([np.asarray(q).astype(np.int8) for q in nq])
    codes = np.stack([np.asarray(c) for c in ds.codes])
    quals = np.stack([np.asarray(q).astype(np.int8) for q in ds.quals])
    arrays = ReadArrays(codes, quals, np.ones(codes.shape, bool),
                        np.asarray(ds.rgs, np.int32),
                        np.asarray(ds.seconds, bool))
    return arrays, RecalConfig(k=16, coverage=20.0, batch_size=128), \
        want, ds


def test_phase_ops_matches_oracle_at_small_width():
    done = cs.phase_ops(B=256, L=60, k=16, log2_m_a=16, log2_m_b=16,
                        walk_chunk=32, sample=32)
    assert done == {k: True for k in ("kmers", "bloom_build", "trusted",
                                      "walk", "permute", "covariates",
                                      "recal")}


def test_phase_golden_engines_match_oracle(tiny_golden, tmp_path):
    res = cs.phase_golden(str(tmp_path), chunk=256, dataset=tiny_golden)
    assert res == {"resident": True, "streamed_fastq": True, "bam": True}


def test_phase_golden_fails_on_a_wrong_golden(tiny_golden, tmp_path):
    arrays, cfg, want, ds = tiny_golden
    bad = want.copy()
    bad[0, 0] ^= 1
    with pytest.raises(cs.SmokeFailure, match="midscale golden"):
        cs.phase_golden(str(tmp_path), chunk=256,
                        dataset=(arrays, cfg, bad, ds))


def test_phase_full_width_cli_routes_agree(tmp_path):
    """The CLI's three routes on bench.py's dataset (against a golden
    computed here by the batched pipeline) and on a larger run."""
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.recalibrate import recalibrate_arrays
    from kbbq_tpu.utils.synth import make_arrays_fast

    n = 512
    arrays, _ = make_arrays_fast(genome_len=int(n * 150 / 50),
                                 read_len=150, num_reads=n,
                                 error_rate=0.005, seed=0)
    golden = tmp_path / "golden.npy"
    np.save(golden, recalibrate_arrays(
        arrays, RecalConfig(k=32, coverage=50.0, batch_size=128)))
    res = cs.phase_full_width(str(tmp_path), "cpu test",
                              golden=(None, str(golden)), bench_reads=n,
                              full_reads=1024, batch=128, k=32)
    for route in cs.ROUTES:
        assert res[f"bench_{route}_vs_cpu_golden"] is True
        assert res[f"ecoli_{route}_warm_s"] > 0
    assert res[f"bench_{cs.BATCHED}_vs_cpu_golden"] is True


def test_phase_four_cards_matches_one_device(tiny_golden):
    res = cs.phase_four_cards("cpu test", devices=4, full_reads=2048,
                              midscale=tiny_golden)
    assert len(res) == 6 and all(res.values())


def test_wrappers_restore_the_engines():
    from kbbq_tpu.parallel import resident_sharded, sharded_bloom
    from kbbq_tpu.pipeline import resident, stream_resident

    before = (resident.recalibrate_arrays_resident,
              stream_resident.recalibrate_fastq_stream_resident,
              stream_resident.recalibrate_bam_stream_resident,
              resident_sharded.build_resident_sharded,
              sharded_bloom.ShardedBloomRecalPipeline.run_pass2,
              stream_resident.FastqWindowSource)
    with cs.engine_timings({}), cs.filter_placement([]), \
            cs._round_robin_read_groups(3):
        assert resident.recalibrate_arrays_resident is not before[0]
        assert stream_resident.FastqWindowSource is not before[5]
    after = (resident.recalibrate_arrays_resident,
             stream_resident.recalibrate_fastq_stream_resident,
             stream_resident.recalibrate_bam_stream_resident,
             resident_sharded.build_resident_sharded,
             sharded_bloom.ShardedBloomRecalPipeline.run_pass2,
             stream_resident.FastqWindowSource)
    assert after == before


def test_main_refuses_the_cpu_backend(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert not _ok_lines(capsys.readouterr().out)


def test_script_exits_nonzero_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)


def test_bench_refuses_the_cpu_backend():
    r = subprocess.run([sys.executable, "bench.py", "--quick"], cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "needs a GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_script_alone_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)


@pytest.mark.gpu
def test_phase_ops_on_the_gpu(gpu_device):
    """The ops phase compiled for the card (no interpret mode anywhere),
    at a reduced batch so it stays a quick test."""
    done = cs.phase_ops(B=1024, L=150, k=32, log2_m_a=22, log2_m_b=22,
                        sample=64)
    assert all(done.values())
