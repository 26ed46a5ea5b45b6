"""Argument parsing + subcommand dispatch.

Reference analog: src/kbbq/main.cc (getopt) and kbbq/main.py (argparse)
(SURVEY.md §3 C1/P1; mount empty, §0).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..constants import DEFAULT_K


def _add_recal_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", nargs="+",
                   help="input FASTQ(s) (.fq[.gz]; each file = one read "
                        "group) or a BAM")
    p.add_argument("-o", "--output", action="append", default=None,
                   help="output path (repeat for multiple inputs; "
                        "default stdout)")
    p.add_argument("-k", "--kmer-size", type=int, default=DEFAULT_K,
                   help=f"k-mer size, <=32 (default {DEFAULT_K})")
    p.add_argument("-g", "--genome-length", type=int, default=None,
                   help="genome length; coverage = total_bases / g")
    p.add_argument("-c", "--coverage", type=float, default=None,
                   help="sequencing coverage (overrides -g derivation)")
    p.add_argument("-a", "--alpha", type=float, default=None,
                   help="k-mer sampling rate (default 7/coverage)")
    p.add_argument("-u", "--use-oq", action="store_true",
                   help="BAM: read base qualities from the OQ tag")
    p.add_argument("-s", "--set-oq", action="store_true",
                   help="BAM: store original qualities into the OQ tag")
    p.add_argument("--batch-size", type=int, default=2048,
                   help="reads per device batch")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices to shard the reads axis over "
                        "(default 1 = single chip; 0 = all available)")
    p.add_argument("--bloom-layout", default="auto",
                   choices=("auto", "replicated", "sharded"),
                   help="multi-device Bloom placement: per-chip replicas "
                        "or hash-space sharded (auto = by filter size)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save/resume pass-boundary checkpoints here")
    from ..constants import DEFAULT_EXT_CAP
    p.add_argument("--ext-cap", type=int, default=DEFAULT_EXT_CAP,
                   help="substitution-trial extension cap W (clamped to "
                        f"k; default {DEFAULT_EXT_CAP} = extend-to-k, "
                        "the reference's semantics; smaller caps trade "
                        "a recorded output deviation for fewer probes, "
                        "see DECISIONS.md D7)")
    p.add_argument("--fasta-ref", default=None,
                   help="reference FASTA for reference-based CRAM input "
                        "(unneeded when slices embed their reference)")
    p.add_argument("--trust-threshold", type=int, default=None,
                   help="override the coverage-derived trusted-kmer "
                        "threshold T (parity calibration knob, D6)")
    p.add_argument("--interleaved", action="store_true",
                   help="FASTQ: reads alternate read1/read2 (pairing by "
                        "position instead of /2 name suffix)")
    p.add_argument("--stream", action="store_true",
                   help="FASTQ: stream chunks from disk each pass "
                        "(bounded host memory; auto-enabled for inputs "
                        "over ~2 GB)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process pod run (jax.distributed): every "
                        "process runs this same command; coordinator/"
                        "process-id resolve from JAX_COORDINATOR, "
                        "JAX_NUM_PROCESSES, JAX_PROCESS_ID (auto-enabled "
                        "when JAX_NUM_PROCESSES > 1)")
    p.add_argument("--chunk-reads", type=int, default=None,
                   help="reads per streamed chunk (default 131072)")
    p.add_argument("--report-out", default=None, metavar="REPORT",
                   help="also write the computed covariates as a "
                        "GATKReport v1.1 recalibration table")
    p.add_argument("--apply-report", default=None, metavar="REPORT",
                   help="skip model building and recalibrate from a "
                        "previously written GATKReport instead "
                        "(ApplyBQSR-equivalent; FASTQ read groups match "
                        "by input path, BAM/CRAM by RG tag)")


def _finish_multihost(stats: dict, dt: float, out=None) -> int:
    """Shared multihost epilogue: per-host stderr summary + the stats
    JSON line the pod launcher collects (one implementation for the
    FASTQ/BAM/CRAM arms — round-5 self-review #8)."""
    import json
    if out is not None:
        print(f"[kbbq-tpu] host {stats['process_id']}/"
              f"{stats['num_processes']}: wrote "
              f"{stats['host_reads_written']} of "
              f"{stats['num_reads']} reads -> {stats['part']} "
              f"in {dt:.2f}s; `cat {out}.part-* > {out}`",
              file=sys.stderr)
    else:
        print(f"[kbbq-tpu] host {stats['process_id']}/"
              f"{stats['num_processes']}: wrote "
              f"{stats['host_reads_written']} of {stats['num_reads']} "
              f"reads in {dt:.2f}s ({stats['devices']} devices)",
              file=sys.stderr)
    print(json.dumps(stats))
    return 0


def cmd_recalibrate(args) -> int:
    from ..pipeline import RecalConfig

    cfg = RecalConfig(
        k=args.kmer_size, alpha=args.alpha, coverage=args.coverage,
        genome_length=args.genome_length, batch_size=args.batch_size,
        trust_threshold=args.trust_threshold, ext_cap=args.ext_cap)
    import os
    report_out = getattr(args, "report_out", None)
    apply_report = getattr(args, "apply_report", None)
    if apply_report and report_out:
        raise SystemExit("--apply-report and --report-out are exclusive")
    multihost = args.multihost or \
        int(os.environ.get("JAX_NUM_PROCESSES", "1")) > 1
    if multihost:
        # BASELINE config 5 (human WGS multi-host) is a CLI-shaped
        # workload: every pod process runs this same command and the
        # streaming driver shards the input files across hosts
        # (parallel/multihost.py; round-2 VERDICT missing #1)
        if args.input[0].endswith(".sam"):
            raise SystemExit(
                "multi-host mode supports FASTQ, BAM and CRAM inputs; "
                "convert SAM to BAM first")
        if args.input[0].endswith(".cram"):
            if len(args.input) != 1:
                raise SystemExit("multi-host CRAM mode takes one input")
            if args.set_oq:
                raise SystemExit(
                    "--set-oq with multi-host CRAM is unsupported (it "
                    "changes tag streams; use the whole-file path)")
            out = (args.output or ["out.cram"])[0]
            from ..parallel.multihost import init_multihost, \
                recalibrate_cram_multihost
            info = init_multihost()
            t0 = time.time()
            stats = recalibrate_cram_multihost(
                args.input[0], out, cfg, use_oq=args.use_oq,
                fasta_ref=args.fasta_ref, info=info,
                checkpoint_dir=args.checkpoint_dir,
                bloom_layout=args.bloom_layout,
                report_out=report_out, apply_report=apply_report)
            return _finish_multihost(stats, time.time() - t0, out)
        if args.input[0].endswith(".bam"):
            if len(args.input) != 1:
                raise SystemExit("multi-host BAM mode takes one input")
            out = (args.output or ["out.bam"])[0]
            from ..parallel.multihost import init_multihost, \
                recalibrate_bam_multihost
            info = init_multihost()
            t0 = time.time()
            stats = recalibrate_bam_multihost(
                args.input[0], out, cfg, use_oq=args.use_oq,
                set_oq=args.set_oq, chunk_records=args.chunk_reads,
                info=info, checkpoint_dir=args.checkpoint_dir,
                bloom_layout=args.bloom_layout,
                report_out=report_out, apply_report=apply_report)
            return _finish_multihost(stats, time.time() - t0, out)
        if args.output is None or len(args.output) != len(args.input):
            raise SystemExit(
                "multi-host mode needs one -o output per input file "
                "(a single concatenated sink is impossible across hosts)")
        from ..parallel.multihost import init_multihost, \
            recalibrate_fastq_multihost
        info = init_multihost()
        t0 = time.time()
        stats = recalibrate_fastq_multihost(
            args.input, args.output, cfg, interleaved=args.interleaved,
            chunk_reads=args.chunk_reads, info=info,
            checkpoint_dir=args.checkpoint_dir,
            bloom_layout=args.bloom_layout,
            report_out=report_out, apply_report=apply_report)
        return _finish_multihost(stats, time.time() - t0)
    devices = args.devices
    if devices == 0:  # 0 = all available
        import jax
        devices = len(jax.devices())
    outs = args.output or ["-"]
    outs = [sys.stdout.buffer if o == "-" else o for o in outs]
    t0 = time.time()
    if args.input[0].endswith(".cram"):
        # own CRAM 3.0 reader (io/cram.py; the reference reads CRAM via
        # htslib, SURVEY.md C7); reference-based files need --fasta-ref
        # unless the slices embed their reference
        if len(args.input) != 1:
            raise SystemExit("CRAM mode takes exactly one input")
        import os
        big = os.path.exists(args.input[0]) and \
            os.path.getsize(args.input[0]) > (2 << 30)
        stream_cram = (args.stream or big) and (devices or 1) <= 1 \
            and not args.set_oq \
            and str(outs[0]).endswith(".cram")
        if stream_cram:
            # container-at-a-time decode + pass-4 QS-block surgery:
            # O(container) memory, original bytes preserved outside QS
            from ..pipeline.cram_stream import \
                recalibrate_cram_stream_resident
            stats = recalibrate_cram_stream_resident(
                args.input[0], outs[0], cfg, use_oq=args.use_oq,
                fasta_ref=args.fasta_ref,
                checkpoint_dir=args.checkpoint_dir,
                report_out=report_out, apply_report=apply_report)
        else:
            from ..pipeline.bam import recalibrate_cram
            stats = recalibrate_cram(args.input[0], outs[0], cfg,
                                     use_oq=args.use_oq,
                                     set_oq=args.set_oq,
                                     fasta_ref=args.fasta_ref,
                                     checkpoint_dir=args.checkpoint_dir,
                                     devices=devices,
                                     bloom_layout=args.bloom_layout,
                                     report_out=report_out,
                                     apply_report=apply_report)
        dt = time.time() - t0
        print(f"[kbbq-tpu] recalibrated {stats['num_reads']} reads "
              f"({stats['total_bases']} bases) in {dt:.2f}s "
              f"({stats['num_reads'] / max(dt, 1e-9):.0f} reads/s)",
              file=sys.stderr)
        return 0
    if args.input[0].endswith((".bam", ".sam")):
        if len(args.input) != 1:
            raise SystemExit("BAM mode takes exactly one input")
        import os
        big = os.path.exists(args.input[0]) and \
            os.path.getsize(args.input[0]) > (2 << 30)
        if args.input[0].endswith(".bam") and (args.stream or big):
            from ..pipeline.bam import recalibrate_bam_streaming
            stats = recalibrate_bam_streaming(
                args.input[0], outs[0], cfg, use_oq=args.use_oq,
                set_oq=args.set_oq, checkpoint_dir=args.checkpoint_dir,
                devices=devices, bloom_layout=args.bloom_layout,
                chunk_records=args.chunk_reads,
                report_out=report_out, apply_report=apply_report)
        else:
            from ..pipeline.bam import recalibrate_bam
            stats = recalibrate_bam(args.input[0], outs[0], cfg,
                                    use_oq=args.use_oq,
                                    set_oq=args.set_oq,
                                    checkpoint_dir=args.checkpoint_dir,
                                    devices=devices,
                                    bloom_layout=args.bloom_layout,
                                    report_out=report_out,
                                    apply_report=apply_report)
    else:
        import os
        total_size = sum(os.path.getsize(p) for p in args.input
                         if os.path.exists(p))
        stream = args.stream or total_size > (2 << 30)
        if stream:
            from ..pipeline.streaming import recalibrate_fastq_streaming
            from ..io.stream import DEFAULT_CHUNK_READS
            stats = recalibrate_fastq_streaming(
                args.input, outs if len(outs) > 1 else outs[0], cfg,
                checkpoint_dir=args.checkpoint_dir,
                interleaved=args.interleaved, devices=devices,
                bloom_layout=args.bloom_layout,
                chunk_reads=args.chunk_reads or DEFAULT_CHUNK_READS,
                report_out=report_out, apply_report=apply_report)
        else:
            from ..pipeline import recalibrate_fastq
            stats = recalibrate_fastq(
                args.input, outs if len(outs) > 1 else outs[0], cfg,
                checkpoint_dir=args.checkpoint_dir,
                interleaved=args.interleaved, devices=devices,
                bloom_layout=args.bloom_layout,
                report_out=report_out, apply_report=apply_report)
    dt = time.time() - t0
    print(f"[kbbq-tpu] recalibrated {stats['num_reads']} reads "
          f"({stats['total_bases']} bases) in {dt:.2f}s "
          f"({stats['num_reads'] / max(dt, 1e-9):.0f} reads/s)",
          file=sys.stderr)
    return 0


def cmd_applybqsr(args) -> int:
    args.apply_report = args.report
    args.report_out = None
    return cmd_recalibrate(args)


def cmd_benchmark(args) -> int:
    from ..benchmark import benchmark_to_tsv
    return benchmark_to_tsv(args)


def cmd_plot(args) -> int:
    from ..plot import plot_benchmark
    plot_benchmark(args.input, args.output)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kbbq-tpu",
        description="reference-free base quality recalibration")
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("recalibrate", help="recalibrate FASTQ/BAM qualities")
    _add_recal_args(pr)
    pr.set_defaults(fn=cmd_recalibrate)

    # ApplyBQSR-equivalent (reference kbbq/gatk/applybqsr.py, SURVEY.md
    # P9): `applybqsr -r report in -o out` == `recalibrate
    # --apply-report report in -o out`
    pa = sub.add_parser(
        "applybqsr",
        help="recalibrate from an existing GATKReport (no model build)")
    _add_recal_args(pa)
    pa.add_argument("-r", "--report", required=True,
                    help="GATKReport recalibration table to apply")
    pa.set_defaults(fn=cmd_applybqsr)

    pb = sub.add_parser(
        "benchmark",
        help="measure actual per-quality error rates from aligned reads")
    pb.add_argument("-b", "--bam", required=True,
                    help="aligned, coordinate-sorted BAM or CRAM")
    pb.add_argument("-r", "--reference", required=True,
                    help="reference FASTA")
    pb.add_argument("-v", "--vcf", required=True,
                    help="VCF of variable sites to exclude")
    pb.add_argument("-f", "--fastq", default=None,
                    help="optional recalibrated FASTQ to score instead")
    pb.add_argument("-l", "--label", default="kbbq-tpu")
    pb.add_argument("-o", "--output", default="-")
    pb.set_defaults(fn=cmd_benchmark)

    pp = sub.add_parser("plot", help="plot calibration curves")
    pp.add_argument("input", help="benchmark TSV")
    pp.add_argument("output", help="output image (pdf/png)")
    pp.set_defaults(fn=cmd_plot)
    return p


def main(argv=None) -> int:
    # before any compile; the platform comes from JAX_PLATFORMS as usual
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if argv is None:
        argv = sys.argv[1:]
    # reference C++ CLI style: `kbbq [opts] input` with no subcommand
    # (SURVEY.md §3.1 C1) — treat a leading non-subcommand arg as an
    # implicit `recalibrate`
    if argv and argv[0] not in ("recalibrate", "applybqsr", "benchmark",
                                "plot", "-h", "--help"):
        argv = ["recalibrate", *argv]
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"kbbq-tpu: error: {e}", file=sys.stderr)
        return 2
    except (ValueError, OSError) as e:
        print(f"kbbq-tpu: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
