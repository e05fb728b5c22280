"""Subcommand: IBL pupil ensemble Kalman smoothing."""

from __future__ import annotations

import argparse
from pathlib import Path

import logging

from eks_tpu_torch.cli._utils import (
    resolve_input,
    add_com_s,
    add_common_args,
    add_devices,
    add_diameter_s,
    handle_io,
    plot_results,
    prepare_device,
    sessions_save_files,
    timed_fit,
)
from eks_tpu_torch.models.ibl_pupil import fit_eks_pupil, fit_eks_pupil_sessions

logger = logging.getLogger(__name__)


def _warn_half_specified_s(args: argparse.Namespace) -> None:
    """Fixing only one of the two pupil smoothing parameters is unsupported,
    as in the JAX package: a half-specified pair is treated as fully-auto and
    BOTH parameters are optimized. Say so instead of silently discarding the
    given value."""
    if (args.diameter_s is None) != (args.com_s is None):
        given = "--diameter-s" if args.diameter_s is not None else "--com-s"
        logger.warning(
            "%s was given without its partner; fixing only one of "
            "--diameter-s/--com-s is unsupported — the value is ignored and "
            "both parameters will be optimized (pass both to fix them)",
            given,
        )


def register(subparsers: argparse._SubParsersAction) -> None:
    parser = subparsers.add_parser(
        "ibl-pupil",
        help="smooth an IBL pupil-tracking ensemble (diameter + center-of-mass model)",
    )
    add_common_args(parser)
    add_diameter_s(parser)
    add_com_s(parser)
    add_devices(parser)
    parser.add_argument(
        "--sessions",
        nargs="+",
        default=None,
        metavar="DIR",
        help="several session input directories smoothed together as one "
        "batched run (one output CSV per session, named "
        "eks_ibl_pupil_<dirname>.csv under --save-dir, or "
        "<session>/outputs/eks_ibl_pupil.csv next to each input when "
        "--save-dir is omitted); the single-lane pupil model "
        "underfills a card, so equal-length sessions sharing one "
        "joint optimizer loop is the throughput mode for session fleets; "
        "it runs on one device and refuses --devices above 1. Without "
        "--sessions, --devices above 1 shards the frame axis: the "
        "optimizer's loss then leaves the fused kernel for a staged one, "
        "about twenty times slower an iteration on H100s",
    )
    parser.set_defaults(handler=cmd_ibl_pupil)


def cmd_ibl_pupil(args: argparse.Namespace) -> None:
    _warn_half_specified_s(args)
    if args.sessions is not None:
        _cmd_ibl_pupil_sessions(args)
        return

    input_source, input_dir = resolve_input(args)
    prepare_device(args)

    save_dir = handle_io(input_dir, args.save_dir)
    save_file = save_dir / (args.save_filename or "eks_ibl_pupil.csv")

    df_smoothed, smooth_params, input_dfs_list, keypoint_names = timed_fit(
        args, fit_eks_pupil,
        input_source=input_source,
        save_file=str(save_file),
        smooth_params=[args.diameter_s, args.com_s],
        s_frames=args.s_frames,
        devices=args.devices,
        partition=args.partition,
        device=args.device,
    )

    if args.make_plot:
        plot_results(
            output_df=df_smoothed,
            input_dfs_list=input_dfs_list,
            key=f"{keypoint_names[-1]}",
            idxs=(0, 500),
            s_final=(smooth_params[0], smooth_params[1]),
            nll_values=None,
            save_dir=str(save_dir),
            smoother_type="ibl_pupil",
        )


def _cmd_ibl_pupil_sessions(args: argparse.Namespace) -> None:
    session_dirs = [Path(d).resolve() for d in args.sessions]
    # the batched pupil entry point takes no devices; more than one must fail
    # here rather than run on one device
    if args.devices is not None and args.devices > 1:
        raise ValueError("ibl-pupil --sessions runs on one device: --devices above 1 is refused "
                         "(fit_eks_pupil_sessions takes no devices)")
    prepare_device(args)
    save_files = sessions_save_files(
        session_dirs, args.save_dir, "eks_ibl_pupil"
    )
    save_dir = Path(save_files[-1]).parent

    smooth_params = None
    if args.diameter_s is not None or args.com_s is not None:
        smooth_params = [args.diameter_s, args.com_s]

    results = timed_fit(
        args, fit_eks_pupil_sessions,
        input_sources=[str(d) for d in session_dirs],
        save_files=save_files,
        smooth_params=smooth_params,
        s_frames=args.s_frames,
        device=args.device,
    )

    if args.make_plot:
        df_smoothed, smooth_params_final, input_dfs_list, keypoint_names = results[-1]
        plot_results(
            output_df=df_smoothed,
            input_dfs_list=input_dfs_list,
            key=f"{keypoint_names[-1]}",
            idxs=(0, 500),
            s_final=(smooth_params_final[0], smooth_params_final[1]),
            nll_values=None,
            save_dir=str(save_dir),
            smoother_type="ibl_pupil",
        )
