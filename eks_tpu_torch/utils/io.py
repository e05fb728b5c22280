"""CSV loading and DLC-format conversion (pandas only).

Input contract (same as ``eks_tpu/utils/io.py`` for one camera): a
directory or a list of prediction CSVs in the DeepLabCut/Lightning-Pose
3-row-header format (scorer / bodyparts / coords). Output CSVs use scorer
``ensemble-kalman_tracker``.

The port reads and writes through pandas only. Per-camera loading (the
multicam families), SLEAP ``.slp`` input and the native C++ reader and
writer of the JAX package are not ported yet; files of other extensions are
skipped as the JAX package skips unknown ones.
"""

from __future__ import annotations

import logging
import os

import pandas as pd

logger = logging.getLogger(__name__)

__all__ = [
    "make_dlc_pandas_index",
    "convert_lp_dlc",
    "get_keypoint_names",
    "format_data",
    "save_dlc_csv",
]

_COORDS = ("x", "y", "likelihood")


def make_dlc_pandas_index(
    keypoint_names: list,
    labels: list = ["x", "y", "likelihood"],
) -> pd.MultiIndex:
    """Three-level (scorer, bodyparts, coords) MultiIndex for output CSVs."""
    return pd.MultiIndex.from_product(
        [["ensemble-kalman_tracker"], keypoint_names, labels],
        names=["scorer", "bodyparts", "coords"],
    )


def save_dlc_csv(df: pd.DataFrame, path: str) -> None:
    """Write an output DataFrame as CSV."""
    df.to_csv(path)


def convert_lp_dlc(
    df_lp: pd.DataFrame,
    keypoint_names: list,
    model_name: str | None = None,
) -> pd.DataFrame:
    """Flatten a (scorer, bodypart, coord) MultiIndex DataFrame into
    ``{keypoint}_{coord}`` columns; missing or unnamed columns are skipped."""
    scorer = str(df_lp.columns[0][0]) if model_name is None else model_name
    present = set(map(tuple, df_lp.columns))

    def _usable(key: tuple) -> bool:
        if key not in present:
            return False
        return not any(
            isinstance(part, str) and part.startswith("Unnamed") for part in key
        )

    flat = {}
    for kp in keypoint_names:
        for coord in _COORDS:
            key = (scorer, kp, coord)
            if _usable(key):
                flat[f"{kp}_{coord}"] = df_lp[key]
    return pd.DataFrame(flat, index=df_lp.index)


def get_keypoint_names(df: pd.DataFrame) -> list:
    """Bodypart names, in column order, from a DLC MultiIndex DataFrame."""
    kps = df.columns[
        df.columns.get_level_values("coords") == "x"
    ].get_level_values("bodyparts")
    return kps.tolist()


def _load_one(file_path: str) -> tuple[pd.DataFrame, list] | None:
    """Load one prediction CSV; None for other extensions."""
    if not file_path.endswith(".csv"):
        return None
    raw = pd.read_csv(file_path, header=[0, 1, 2], index_col=0)
    keypoint_names = get_keypoint_names(raw)
    return convert_lp_dlc(raw, keypoint_names), keypoint_names


def _candidate_paths(input_source) -> list:
    """Normalize the input_source forms to a sorted path list."""
    if isinstance(input_source, str) and os.path.isdir(input_source):
        return sorted(
            os.path.join(input_source, f) for f in os.listdir(input_source)
        )
    if isinstance(input_source, list):
        return sorted(input_source)
    raise ValueError(
        f"cannot interpret input_source of type {type(input_source).__name__}; "
        "pass a directory or a list of prediction files"
    )


def format_data(input_source: str | list) -> tuple[list, list]:
    """Load one camera's prediction files into DataFrames.

    Args:
        input_source: a directory path or a list of file paths, one CSV per
            ensemble model.

    Returns:
        (input_dfs_list, keypoint_names): a flat list of model DataFrames
        with ``{keypoint}_{coord}`` columns, and the keypoint names.
    """
    input_dfs_list: list = []
    keypoint_names = None
    for fp in _candidate_paths(input_source):
        loaded = _load_one(fp)
        if loaded is None:
            continue
        df, keypoint_names = loaded
        input_dfs_list.append(df)
    if len(input_dfs_list) == 0:
        raise FileNotFoundError(
            f"found no loadable prediction files in {input_source}"
        )
    return input_dfs_list, keypoint_names
