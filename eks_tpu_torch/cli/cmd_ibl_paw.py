"""Subcommand: IBL paw multi-view ensemble Kalman smoothing."""

from __future__ import annotations

import argparse

from eks_tpu_torch.cli._utils import (
    resolve_input,
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
from eks_tpu_torch.models.ibl_paw import fit_eks_multicam_ibl_paw


def register(subparsers: argparse._SubParsersAction) -> None:
    parser = subparsers.add_parser(
        "ibl-paw",
        help="smooth an IBL two-camera paw ensemble with asynchronous timestamps",
    )
    add_common_args(parser)
    add_s(parser)
    add_quantile_keep_pca(parser)
    add_inflate_vars(parser)
    add_n_latent(parser)
    add_devices(parser)
    parser.set_defaults(handler=cmd_ibl_paw)


def cmd_ibl_paw(args: argparse.Namespace) -> None:
    input_source, input_dir = resolve_input(args)
    prepare_device(args)

    save_dir = handle_io(input_dir, args.save_dir)

    camera_dfs, s_finals, input_dfs, bodypart_list = timed_fit(
        args, fit_eks_multicam_ibl_paw,
        input_source=input_source,
        save_dir=str(save_dir),
        smooth_param=args.s,
        s_frames=args.s_frames,
        quantile_keep_pca=args.quantile_keep_pca,
        var_mode="var",
        inflate_vars=args.inflate_vars,
        n_latent=args.n_latent,
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
            smoother_type="ibl_paw",
            coords=["x", "y"],
        )
