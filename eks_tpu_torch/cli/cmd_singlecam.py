"""Subcommand: single-camera ensemble Kalman smoothing."""

from __future__ import annotations

import argparse
from pathlib import Path

from eks_tpu_torch.cli._utils import (
    resolve_input,
    add_bodyparts,
    add_common_args,
    add_devices,
    add_s,
    handle_io,
    plot_results,
    prepare_device,
    sessions_save_files,
    timed_fit,
)
from eks_tpu_torch.models.singlecam import fit_eks_singlecam, fit_eks_singlecam_sessions


def register(subparsers: argparse._SubParsersAction) -> None:
    parser = subparsers.add_parser(
        "singlecam",
        help="smooth a single-camera pose ensemble",
    )
    add_common_args(parser)
    add_bodyparts(parser)
    add_s(parser)
    add_devices(parser)
    parser.add_argument(
        "--sessions",
        nargs="+",
        default=None,
        metavar="DIR",
        help="several session input directories smoothed together as one "
        "batched run (one output CSV per session: "
        "eks_singlecam_<dirname>.csv under --save-dir, or "
        "<session>/outputs/eks_singlecam.csv next to each input when "
        "--save-dir is omitted); equal-length sessions stack as keypoint "
        "lanes of one optimizer and one final pass",
    )
    parser.set_defaults(handler=cmd_singlecam)


def cmd_singlecam(args: argparse.Namespace) -> None:
    if args.sessions is not None:
        _cmd_singlecam_sessions(args)
        return

    input_source, input_dir = resolve_input(args)
    prepare_device(args)

    save_dir = handle_io(input_dir, args.save_dir)
    save_file = save_dir / (args.save_filename or "eks_singlecam.csv")

    output_df, s_finals, input_dfs, bodypart_list = timed_fit(
        args, fit_eks_singlecam,
        input_source=input_source,
        save_file=str(save_file),
        bodypart_list=args.bodypart_list,
        smooth_param=args.s,
        s_frames=args.s_frames,
        blocks=args.blocks,
        devices=args.devices,
        partition=args.partition,
        device=args.device,
        # under --verbose the entry point's spans join the run report
        timings=args.timings,
    )

    if args.make_plot:
        plot_results(
            output_df=output_df,
            input_dfs_list=input_dfs,
            key=f"{bodypart_list[-1]}",
            idxs=(0, 500),
            s_final=s_finals[-1],
            nll_values=None,
            save_dir=str(save_dir),
            smoother_type="singlecam",
        )


def _cmd_singlecam_sessions(args: argparse.Namespace) -> None:
    session_dirs = [Path(d).resolve() for d in args.sessions]
    prepare_device(args)
    save_files = sessions_save_files(
        session_dirs, args.save_dir, "eks_singlecam"
    )
    save_dir = Path(save_files[-1]).parent

    # the CLI's --blocks / --s settings apply to every session (sessions in
    # one batch share a keypoint layout)
    blocks = [args.blocks] * len(session_dirs) if args.blocks else None
    smooth_param = [args.s] * len(session_dirs) if args.s is not None else None
    results = timed_fit(
        args, fit_eks_singlecam_sessions,
        input_sources=[str(d) for d in session_dirs],
        save_files=save_files,
        bodypart_list=args.bodypart_list,
        smooth_param=smooth_param,
        s_frames=args.s_frames,
        blocks=blocks,
        devices=args.devices,
        partition=args.partition,
        device=args.device,
    )

    if args.make_plot:
        output_df, s_finals, input_dfs, bodypart_list = results[-1]
        plot_results(
            output_df=output_df,
            input_dfs_list=input_dfs,
            key=f"{bodypart_list[-1]}",
            idxs=(0, 500),
            s_final=s_finals[-1],
            nll_values=None,
            save_dir=str(save_dir),
            smoother_type="singlecam",
        )
