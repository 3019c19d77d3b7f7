"""Command-line interface.

Preserves the reference's three-stage UX and flags (reference
main.py:302-498): ``convert``, ``newref``, ``gender``, ``predict`` — so
existing WisecondorX pipelines can switch by swapping the executable.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from wisecondorx_tpu.io.npz import (
    load_reference_npz,
    load_sample_npz,
    save_sample_npz,
)
from wisecondorx_tpu.utils.log import setup_logging


def tool_convert(args):
    from wisecondorx_tpu.io.bam import convert_reads

    logging.info("Starting conversion")
    sample, qual_info = convert_reads(
        args.infile,
        binsize=args.binsize,
        reference_fasta=args.reference,
        normdup=args.normdup,
    )
    save_sample_npz(args.outfile, args.binsize, sample, qual_info)
    logging.info("Finished conversion")


def tool_newref(args):
    from concurrent.futures import ThreadPoolExecutor

    from wisecondorx_tpu.models.reference import (
        NewrefConfig,
        NewrefError,
        build_reference,
    )
    from wisecondorx_tpu.parallel.multihost import (
        maybe_initialize_distributed,
    )
    from wisecondorx_tpu.ref_qc import qc_reference_arrays
    from wisecondorx_tpu.utils.device import log_backend
    from wisecondorx_tpu.utils.log import stage_timer

    # Distributed init must precede anything touching the jax backend; a
    # coordinator-configured multi-host newref then row-shards its KNN
    # across processes instead of silently degrading to one.
    maybe_initialize_distributed()
    log_backend()
    logging.info("Creating new reference")
    with stage_timer("newref.load_inputs"):
        # Parallel parse: the zlib decompression inside np.load releases
        # the GIL, so a cohort of hundreds of convert npzs loads several
        # times faster than the serial loop.
        def load_one(infile):
            logging.debug("Loading: %s", infile)
            sample, binsize, _ = load_sample_npz(infile)
            return sample, binsize
        with ThreadPoolExecutor(max_workers=8) as pool:
            samples = list(pool.map(load_one, args.infiles))
        logging.info(
            "Loaded %d samples (binsize %d)",
            len(samples), samples[0][1] if samples else 0,
        )

    if args.plotyfrac is not None:
        # reference newref_tools.py:42-52: plot the GMM fit for --yfrac
        # tuning, then stop.
        from wisecondorx_tpu.io.npz import scale_sample
        from wisecondorx_tpu.ops.gmm import train_gender_model

        scaled = [
            scale_sample(s, bs, int(args.binsize)) for s, bs in samples
        ]
        _, _, fit = train_gender_model(
            scaled, yfrac_override=args.yfrac, random_state=args.seed
        )
        _require_matplotlib("--plotyfrac")
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(16, 6))
        ax.hist(fit["y_fractions"], bins=100, density=True)
        ax.plot(
            fit["grid"], fit["density"], "r-", label="Gaussian mixture fit"
        )
        ax.set_xlim([0, 0.02])
        ax.legend(loc="best")
        plt.savefig(args.plotyfrac)
        logging.info(
            "Image written to %s, now quitting ...", args.plotyfrac
        )
        sys.exit(0)

    cfg = NewrefConfig(
        binsize=int(args.binsize),
        refsize=args.refsize,
        nipt=args.nipt,
        yfrac=args.yfrac,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
    )
    try:
        passes, meta = build_reference(samples, cfg)
    except NewrefError as e:
        logging.critical(str(e))
        sys.exit(1)

    outfile = args.outfile
    if not outfile.endswith(".npz"):
        outfile += ".npz"
    from wisecondorx_tpu.io.npz import flatten_reference

    final = flatten_reference(
        passes,
        is_nipt=meta["is_nipt"],
        trained_cutoff=meta["trained_cutoff"],
    )
    with stage_timer("newref.write"):
        from wisecondorx_tpu.io.npz import _savez_fast, verify_reference_npz

        _savez_fast(outfile, final)
        logging.info("Reference written to %s", outfile)
    with stage_timer("newref.verify"):
        # CRC + member-set check of the file the user will actually load
        # — the in-memory QC below never re-reads it.
        verify_reference_npz(outfile, expected_keys=final.keys())
    logging.info("Running QC on the newly created reference...")
    with stage_timer("newref.qc"):
        # Scored from the in-memory arrays — same flat mapping the file
        # holds, minus the ~0.5 GB re-decompression.
        qc_reference_arrays(final, label=outfile)
    logging.info("Finished creating reference")


def output_gender(args):
    from wisecondorx_tpu.ops.gmm import predict_gender

    sample, _, _ = load_sample_npz(args.infile)
    ref = np.load(args.reference, encoding="latin1", allow_pickle=True)
    gender = predict_gender(sample, float(ref["trained_cutoff"]))
    print("male" if gender == "M" else "female")


def tool_test(args):
    from wisecondorx_tpu.models.predictor import (
        PredictConfig,
        PredictError,
        predict,
    )
    from wisecondorx_tpu.output.tables import generate_output_tables
    from wisecondorx_tpu.utils.device import log_backend

    logging.info("Starting CNA prediction")
    if not args.bed and not args.plot:
        logging.critical(
            "No output format selected. "
            "Select at least one of the supported output formats "
            "(--bed, --plot)"
        )
        sys.exit(1)
    if args.plot:
        _require_matplotlib("--plot")
    _predict_in_float64()
    log_backend()

    cfg = PredictConfig(
        minrefbins=args.minrefbins,
        maskrepeats=args.maskrepeats,
        alpha=args.alpha,
        zscore=args.zscore,
        beta=args.beta,
        blacklist=args.blacklist,
        gender=args.gender,
        seed=args.seed,
    )
    try:
        cfg.validate()
    except PredictError as e:
        logging.critical(str(e))
        sys.exit(1)

    logging.info("Importing data ...")
    from wisecondorx_tpu.models.ref_loader import ReferenceLoader

    sample, sample_binsize, _ = load_sample_npz(args.infile)
    loader = ReferenceLoader(args.reference)

    try:
        bins, segments = predict(
            sample, sample_binsize, loader.passes, loader.meta, cfg,
            loader=loader,
        )
    except PredictError as e:
        logging.critical(str(e))
        sys.exit(1)

    if args.bed:
        logging.info("Writing tables ...")
        generate_output_tables(
            args.outid, bins, segments, cfg, regions=args.regions
        )
    if args.plot:
        logging.info("Writing plots ...")
        from wisecondorx_tpu.output.plots import write_plots

        write_plots(
            args.outid,
            bins,
            segments,
            cfg,
            ylim=args.ylim,
            regions=args.regions,
            plot_title=(
                args.outid.split("/")[-1] if args.add_plot_title else None
            ),
        )
    logging.info("Finished prediction")


def tool_test_batch(args):
    """Score a plate of samples against one reference in a single
    invocation — the batched, data-parallel production path (no reference
    equivalent; the reference scores one sample per process)."""
    import os

    import jax

    from wisecondorx_tpu.models.predictor import (
        PredictConfig,
        PredictError,
        segment_bins_batch,
    )
    from wisecondorx_tpu.output.tables import generate_output_tables
    from wisecondorx_tpu.parallel.batch import predict_batch
    from wisecondorx_tpu.parallel.mesh import sample_mesh
    from wisecondorx_tpu.parallel.multihost import (
        maybe_initialize_distributed,
        shard_files,
    )
    from wisecondorx_tpu.utils.device import log_backend

    if not args.bed and not args.plot:
        logging.critical(
            "No output format selected. "
            "Select at least one of the supported output formats "
            "(--bed, --plot)"
        )
        sys.exit(1)
    if args.plot:
        _require_matplotlib("--plot")

    cfg = PredictConfig(
        minrefbins=args.minrefbins,
        maskrepeats=args.maskrepeats,
        alpha=args.alpha,
        zscore=args.zscore,
        beta=args.beta,
        blacklist=args.blacklist,
        gender=args.gender,
        seed=args.seed,
    )
    try:
        cfg.validate()
    except PredictError as e:
        logging.critical(str(e))
        sys.exit(1)

    os.makedirs(args.outdir, exist_ok=True)
    # Multi-host: each process scores its own shard of the plate (pure
    # data parallelism — no cross-host traffic).  Distributed init MUST
    # precede anything that initializes the jax backend.
    _predict_in_float64()
    pidx, pcount = maybe_initialize_distributed()
    log_backend()
    infiles = shard_files(args.infiles, pidx, pcount)
    if pcount > 1:
        logging.info(
            "Process %d/%d takes %d of %d samples",
            pidx, pcount, len(infiles), len(args.infiles),
        )
    # Skip-and-report: one corrupt npz must not abort the plate — the
    # remaining samples are scored and the exit code reflects the
    # partial failure (reference has no batch mode; its per-process exit
    # semantics don't transfer to a plate CLI).
    import pickle
    import zipfile

    from wisecondorx_tpu.errors import UserInputError

    loaded = []
    outids = []
    infiles_loaded = []
    failed = []
    for infile in infiles:
        try:
            sample, binsize, _ = load_sample_npz(infile)
        except (
            UserInputError,
            FileNotFoundError,
            KeyError,
            zipfile.BadZipFile,
            pickle.UnpicklingError,
        ) as e:
            logging.error("Skipping unreadable sample %s: %s", infile, e)
            failed.append(infile)
            continue
        infiles_loaded.append(infile)
        loaded.append((sample, binsize))
        base = os.path.basename(infile)
        outids.append(
            os.path.join(args.outdir, base[:-4] if base.endswith(".npz") else base)
        )
    # The wcx_* caches replace the distance tables at the default
    # maskrepeats depth — skip ~1 GB of member loading when possible.
    passes, meta = load_reference_npz(
        args.reference, skip_distances_if_cached=(args.maskrepeats == 5)
    )

    # Local devices only: under multi-host each process data-parallels its
    # own shard over its own chips.
    devices = jax.local_devices()
    mesh = sample_mesh(devices) if len(devices) > 1 else None
    logging.info(
        "Batch prediction: %d samples over %d device(s)",
        len(loaded),
        len(devices),
    )
    try:
        all_bins = predict_batch(
            loaded, passes, meta, cfg, mesh=mesh, chunk=args.chunk,
            skip_errors=True,
        )
    except PredictError as e:
        logging.critical(str(e))
        sys.exit(1)

    good = []
    for infile, outid, bins in zip(infiles_loaded, outids, all_bins):
        if bins is None:
            failed.append(infile)
        else:
            good.append((outid, bins))

    # One batched CBS engine run for the whole plate: all samples'
    # segments share device dispatches instead of a per-sample host loop.
    all_segments = segment_bins_batch([b for _, b in good], cfg)
    for (outid, bins), segments in zip(good, all_segments):
        if args.bed:
            generate_output_tables(
                outid, bins, segments, cfg, regions=args.regions
            )
        if args.plot:
            from wisecondorx_tpu.output.plots import write_plots

            write_plots(
                outid, bins, segments, cfg, ylim=args.ylim,
                regions=args.regions,
                plot_title=(
                    outid.split("/")[-1] if args.add_plot_title else None
                ),
            )
        logging.info("Wrote %s", outid)
    logging.info("Finished batch prediction")
    if failed:
        # Denominator = this process's shard (under multi-host sharding
        # each process accounts for its own slice of the plate).
        logging.error(
            "%d of %d samples in this process's shard failed and were "
            "skipped (see errors above): %s",
            len(failed), len(infiles), ", ".join(failed),
        )
        sys.exit(3)


def _predict_in_float64() -> None:
    """Run the predict stage in float64 on every backend, like the
    reference's numpy: in float32 a bin's z-score can land on the other
    side of the aberrant-bin masking threshold, which moves the ratios of
    every bin that uses it as a neighbour (PERF.md, PR 1).  The stage's
    device work is small, so the cost is too."""
    import jax

    jax.config.update("jax_enable_x64", True)


def _require_matplotlib(flag: str) -> None:
    """Exit with a clear message when plotting is asked for but the
    optional matplotlib dependency is not installed."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        logging.critical(
            "%s needs matplotlib, which is not installed; install it "
            "(pip install 'wisecondorx-tpu[plot]') or drop %s",
            flag, flag,
        )
        sys.exit(1)


def build_parser() -> argparse.ArgumentParser:
    from wisecondorx_tpu.parallel.batch import DEFAULT_CHUNK

    parser = argparse.ArgumentParser(description="WisecondorX-TPU")
    parser.add_argument(
        "--loglevel",
        type=str,
        default="INFO",
        choices=["info", "warning", "debug", "error", "critical"],
    )
    sub = parser.add_subparsers()

    p = sub.add_parser(
        "convert",
        description="Convert and filter aligned reads to .npz",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument(
        "infile", type=str, help="aligned reads input (.bam or .cram)"
    )
    p.add_argument("outfile", type=str, help="Output .npz file")
    p.add_argument(
        "-r", "--reference", type=str,
        help="Fasta reference (accepted for compatibility; the native "
        "CRAM reader does not reconstruct sequences and needs no fasta)",
    )
    p.add_argument("--binsize", type=float, default=5e3, help="Bin size (bp)")
    p.add_argument(
        "--normdup", action="store_true", help="Do not remove duplicates"
    )
    p.set_defaults(func=tool_convert)

    p = sub.add_parser(
        "newref",
        description="Create a new reference using healthy reference samples",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("infiles", type=str, nargs="+")
    p.add_argument("outfile", type=str)
    p.add_argument("--nipt", action="store_true")
    p.add_argument("--yfrac", type=float, default=None)
    p.add_argument("--plotyfrac", type=str, default=None)
    p.add_argument("--refsize", type=int, default=300)
    p.add_argument("--binsize", type=int, default=int(1e5))
    p.add_argument(
        "--cpus", type=int, default=1,
        help="Kept for CLI compatibility; the KNN search runs on the "
        "accelerator and ignores this",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--checkpoint-dir", type=str, default=None,
        help="Directory for crash-recovery artifacts; a killed build "
        "re-run with the same inputs resumes after the last completed "
        "stage (removed on success)",
    )
    p.set_defaults(func=tool_newref)

    p = sub.add_parser(
        "gender",
        description="Returns the gender of a .npz resulting from convert",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("infile", type=str)
    p.add_argument("reference", type=str)
    p.set_defaults(func=output_gender)

    p = sub.add_parser(
        "predict",
        description="Find copy number aberrations",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("infile", type=str)
    p.add_argument("reference", type=str)
    p.add_argument("outid", type=str)
    p.add_argument("--minrefbins", type=int, default=150)
    p.add_argument("--maskrepeats", type=int, default=5)
    p.add_argument("--alpha", type=float, default=1e-4)
    p.add_argument("--zscore", type=float, default=5)
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--blacklist", type=str, default=None)
    p.add_argument("--gender", type=str, choices=["F", "M"])
    p.add_argument("--ylim", type=str, default="def")
    p.add_argument("--bed", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--cairo", action="store_true")
    p.add_argument("--add-plot-title", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--regions", type=str, default=None)
    p.set_defaults(func=tool_test)

    p = sub.add_parser(
        "predict-batch",
        description="Find copy number aberrations for a batch of samples "
        "in one invocation (data-parallel over all devices)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("reference", type=str)
    p.add_argument("outdir", type=str, help="Output directory; per-sample "
                   "outid = <outdir>/<input basename without .npz>")
    p.add_argument("--infiles", type=str, nargs="+", required=True)
    p.add_argument("--chunk", type=int, default=DEFAULT_CHUNK,
                   help="Samples normalized per device per dispatch "
                   "(outputs equal solo predict's at the default)")
    p.add_argument("--minrefbins", type=int, default=150)
    p.add_argument("--maskrepeats", type=int, default=5)
    p.add_argument("--alpha", type=float, default=1e-4)
    p.add_argument("--zscore", type=float, default=5)
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--blacklist", type=str, default=None)
    p.add_argument("--gender", type=str, choices=["F", "M"])
    p.add_argument("--ylim", type=str, default="def")
    p.add_argument("--bed", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--cairo", action="store_true")
    p.add_argument("--add-plot-title", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--regions", type=str, default=None)
    p.set_defaults(func=tool_test_batch)

    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    setup_logging(args.loglevel)
    logging.debug("args are: %s", args)
    if not hasattr(args, "func"):
        parser.print_help()
        sys.exit(1)
    from wisecondorx_tpu.utils.device import (
        pin_autotuning,
        setup_compile_cache,
    )

    pin_autotuning()
    setup_compile_cache()
    # Every user-input failure in any subcommand becomes a one-line
    # critical log + exit, matching the reference's handling (reference
    # overall_tools.py:26-39, main.py:99-102) — no raw tracebacks for bad
    # files, impossible binsize rescales, or missing inputs.
    import pickle
    import zipfile

    from wisecondorx_tpu.errors import UserInputError

    try:
        args.func(args)
    except UserInputError as e:
        logging.critical(str(e))
        sys.exit(1)
    except FileNotFoundError as e:
        logging.critical("Input file not found: %s", e.filename or e)
        sys.exit(1)
    except (zipfile.BadZipFile, pickle.UnpicklingError) as e:
        # np.load signals non-npz content either way depending on the
        # corruption mode.
        logging.critical("Not a valid .npz file: %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
