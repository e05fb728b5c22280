"""Subcommand: multi-camera ensemble Kalman smoothing."""

from __future__ import annotations

import argparse
import logging

from eks_tpu_torch.cli._utils import (
    resolve_input,
    add_bodyparts,
    add_calibration,
    add_camera_names,
    add_common_args,
    add_devices,
    add_inflate_vars,
    add_n_latent,
    add_quantile_keep_pca,
    add_s,
    handle_io,
    plot_results,
    prepare_device,
    timed_fit,
)
from eks_tpu_torch.models.multicam import fit_eks_multicam

logger = logging.getLogger(__name__)


def register(subparsers: argparse._SubParsersAction) -> None:
    parser = subparsers.add_parser(
        "multicam",
        help="smooth a multi-camera pose ensemble (PCA-latent or calibrated 3D)",
    )
    add_common_args(parser)
    add_bodyparts(parser)
    add_camera_names(parser)
    add_s(parser)
    add_quantile_keep_pca(parser)
    add_inflate_vars(parser)
    add_n_latent(parser)
    add_calibration(parser)
    add_devices(parser)
    parser.set_defaults(handler=cmd_multicam)


def cmd_multicam(args: argparse.Namespace) -> None:
    if args.calibration is None and args.camera_names is None:
        raise ValueError("pass --camera-names when running without --calibration")
    if args.calibration is not None and args.camera_names is not None:
        logger.warning(
            "--calibration overrides --camera-names; "
            "names are taken from the TOML"
        )

    input_source, input_dir = resolve_input(args)
    prepare_device(args)

    save_dir = handle_io(input_dir, args.save_dir)

    camera_dfs, s_finals, input_dfs, bodypart_list, df_3d = timed_fit(
        args, fit_eks_multicam,
        input_source=input_source,
        save_dir=str(save_dir),
        bodypart_list=args.bodypart_list,
        smooth_param=args.s,
        s_frames=args.s_frames,
        camera_names=args.camera_names,
        quantile_keep_pca=args.quantile_keep_pca,
        inflate_vars=args.inflate_vars,
        n_latent=args.n_latent,
        calibration=args.calibration,
        devices=args.devices,
        partition=args.partition,
        device=args.device,
    )

    if args.make_plot:
        plot_results(
            output_df=camera_dfs[-1],
            input_dfs_list=input_dfs[-1],
            key=f"{bodypart_list[-1]}",
            idxs=(0, 500),
            s_final=s_finals[-1],
            nll_values=None,
            save_dir=str(save_dir),
            smoother_type="multicam",
        )
