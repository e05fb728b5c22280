"""CSV and SLEAP ``.slp`` loading and DLC-format conversion.

Input contract (same as ``eks_tpu/utils/io.py``): a directory, a list of
files, or a {camera: [files]} dict of prediction CSVs in the
DeepLabCut/Lightning-Pose 3-row-header format (scorer / bodyparts / coords),
or SLEAP ``.slp`` files. Output CSVs use scorer ``ensemble-kalman_tracker``.

CSVs are read and written through the native C++ reader and writer
(``eks_tpu_torch.native``, copies of the JAX package's): the reader gives the
same float64 bits as the JAX package's, and the writer is byte-identical to
``df.to_csv``. pandas takes over where they do not apply (a file the reader
does not parse, a table of mixed dtypes or another index, no compiler), and
for every CSV when ``EKS_TPU_TORCH_NATIVE_CSV=0``; ``native.READS`` and
``native.WRITES`` count which path each read and write took.

``.slp`` files are HDF5 containers, read through h5py (imported only when a
``.slp`` file is loaded, so the package imports without it); as in the JAX
package, each one also leaves a flat ``{file}.csv`` copy in the working
directory. Files of other extensions are skipped as the JAX package skips
them.

Output tables cross from the card once: ``pull_outputs`` brings an entry
point's results to the host in one copy, and ``dlc_frame`` wraps a table
around (a view of) that copy, without copying it again, over a cached DLC
column index.
"""

from __future__ import annotations

import functools
import json
import logging
import os

import numpy as np
import pandas as pd
import torch

from eks_tpu_torch import native, tracing

logger = logging.getLogger(__name__)

__all__ = [
    "dlc_frame",
    "make_dlc_pandas_index",
    "pull_outputs",
    "convert_lp_dlc",
    "convert_slp_dlc",
    "read_slp_predictions",
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


@functools.lru_cache(maxsize=64)
def _dlc_columns(keypoint_names: tuple, labels: tuple) -> pd.MultiIndex:
    tracing.count(("frame", "index_built"))
    return make_dlc_pandas_index(list(keypoint_names), list(labels))


def dlc_frame(array2d: np.ndarray, keypoint_names, labels) -> pd.DataFrame:
    """An output table over ``array2d`` (frames, keypoints × labels), which
    must be the call's own: a fresh host copy of its results or a view of
    one. The frame wraps the array without copying it (pandas copies a 2-D
    array by default), so writing into the frame writes into the array. Its
    columns are its own shallow copy of a cached DLC index, so renaming one
    frame's levels leaves every other frame's as they were. Counted in
    ``tracing.LAUNCHES`` as ``("frame", "wrapped")``, and as ``("frame",
    "index_built")`` where the index was not cached."""
    columns = _dlc_columns(tuple(keypoint_names), tuple(labels)).copy()
    tracing.count(("frame", "wrapped"))
    return pd.DataFrame(array2d, columns=columns, copy=False)


def pull_outputs(*tensors: torch.Tensor) -> list[np.ndarray]:
    """An entry point's results on the host in one device-to-host copy: the
    tensors (one dtype, one device; a single one must be the call's own)
    are laid end to end in one buffer, which comes back as numpy views with
    the tensors' shapes. The tables built over them alias that buffer, so it
    is a fresh one each call. Counted as ``("output_pull",)``."""
    flat = [t.reshape(-1) for t in tensors]
    host = (torch.cat(flat) if len(flat) > 1 else flat[0]).cpu().numpy()
    tracing.count(("output_pull",))
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _native_csv() -> bool:
    return os.environ.get("EKS_TPU_TORCH_NATIVE_CSV", "1") != "0"


def save_dlc_csv(df: pd.DataFrame, path: str) -> None:
    """Write an output DataFrame as CSV, byte-identical to
    ``df.to_csv(path)``: through the native writer where it applies (a
    homogeneous float table with a unit-step integer index, which every
    smoother output is), else through pandas."""
    if _native_csv() and native.write_dlc_csv_fast(df, path):
        native.WRITES["native"] += 1
        return
    df.to_csv(path)
    native.WRITES["pandas"] += 1


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


# --------------------------------------------------------------------------- #
# SLEAP .slp files (HDF5, through h5py)
# --------------------------------------------------------------------------- #
def _slp_node_names(h5file) -> list[str]:
    """Skeleton node names, in skeleton order, from the JSON document the
    container keeps in the ``json`` attribute of ``/metadata``."""
    blob = h5file["metadata"].attrs["json"]
    if isinstance(blob, bytes):
        blob = blob.decode("utf-8")
    return [node["name"] for node in json.loads(blob)["nodes"]]


def read_slp_predictions(file_path: str) -> tuple[np.ndarray, list[str]]:
    """A SLEAP ``.slp`` file as a dense (frames, instances, nodes, 3) array
    of (x, y, score), and the node names.

    Each row of ``frames`` points at a span of ``instances`` rows, each of
    which points at a span of ``points`` (user labels) or ``pred_points``
    (predictions, with a score per point); ``instance_type == 1`` marks a
    prediction. The instance count is the first frame's, missing
    coordinates read 0, and every score gets 1e-6 added (a label's score is
    0), as the JAX package reads them."""
    import h5py

    with h5py.File(file_path, "r") as f:
        node_names = _slp_node_names(f)
        frames = f["frames"][:]
        instances = f["instances"][:]
        points = f["points"][:] if "points" in f else np.empty((0,))
        pred_points = f["pred_points"][:] if "pred_points" in f else np.empty((0,))

    n_nodes, n_frames = len(node_names), len(frames)
    if n_frames == 0:
        return np.zeros((0, 0, n_nodes, 3)), node_names
    spans = [(int(row["instance_id_start"]), int(row["instance_id_end"])) for row in frames]
    max_instances = spans[0][1] - spans[0][0]

    dense = np.zeros((n_frames, max_instances, n_nodes, 3))
    for fi, (lo, hi) in enumerate(spans):
        for slot, inst in enumerate(instances[lo:hi][:max_instances]):
            predicted = int(inst["instance_type"]) == 1
            rows = (pred_points if predicted else points)[int(inst["point_id_start"]):int(inst["point_id_end"])]
            for k in range(min(n_nodes, len(rows))):
                x, y = float(rows[k]["x"]), float(rows[k]["y"])
                dense[fi, slot, k, 0] = 0.0 if np.isnan(x) else x
                dense[fi, slot, k, 1] = 0.0 if np.isnan(y) else y
                dense[fi, slot, k, 2] = (float(rows[k]["score"]) if predicted else 0.0) + 1e-6
    return dense, node_names


def convert_slp_dlc(base_dir: str, slp_file: str) -> tuple:
    """A SLEAP ``.slp`` file as a flat DataFrame with
    ``{instance}_{keypoint}_{coord}`` columns (instances counted from 1),
    and its keypoint names. Writes the same table to ``{slp_file}.csv`` in
    the working directory, as the JAX package does."""
    dense, keypoint_names = read_slp_predictions(os.path.join(base_dir, slp_file))
    n_frames, max_instances = dense.shape[:2]
    columns = [
        f"{j + 1}_{kp}_{coord}"
        for j in range(max_instances)
        for kp in keypoint_names
        for coord in _COORDS
    ]
    df = pd.DataFrame(dense.reshape(n_frames, -1), columns=columns)
    df.to_csv(f"{slp_file}.csv", index=False)
    logger.info(f"converted {slp_file}; flat copy written to {slp_file}.csv")
    return df, keypoint_names


def get_keypoint_names(df: pd.DataFrame) -> list:
    """Bodypart names, in column order, from a DLC MultiIndex DataFrame."""
    kps = df.columns[
        df.columns.get_level_values("coords") == "x"
    ].get_level_values("bodyparts")
    return kps.tolist()


def _load_one_native(file_path: str) -> tuple[pd.DataFrame, list] | None:
    """Load a DLC CSV through the native reader: the same flat-column
    DataFrame ``convert_lp_dlc`` builds from the pandas path. None when the
    reader is unavailable or the file does not parse."""
    parsed = native.load_dlc_csv_fast(file_path)
    if parsed is None:
        return None
    data, headers = parsed
    scorers, bodyparts, coords = (h[1:] for h in headers)  # drop index cells
    if len(bodyparts) != data.shape[1] or len(coords) != data.shape[1]:
        return None
    keypoint_names = [bp for bp, c in zip(bodyparts, coords) if c == "x"]
    model_name = scorers[0] if scorers else ""
    col_index: dict[tuple, int] = {}
    for i, key in enumerate(zip(scorers, bodyparts, coords)):
        col_index.setdefault(key, i)
    out = {}
    for kp in keypoint_names:
        for coord in _COORDS:
            key = (model_name, kp, coord)
            if any(level.startswith("Unnamed") for level in key):
                continue
            idx = col_index.get(key)
            if idx is not None:
                out[f"{kp}_{coord}"] = data[:, idx]
    return pd.DataFrame(out), keypoint_names


def _load_one(file_path: str) -> tuple[pd.DataFrame, list] | None:
    """Load one prediction file (``.csv`` or ``.slp``); None for other
    extensions."""
    if file_path.endswith(".slp"):
        return convert_slp_dlc(os.path.dirname(file_path), os.path.basename(file_path))
    if not file_path.endswith(".csv"):
        return None
    if _native_csv():
        loaded = _load_one_native(file_path)
        if loaded is not None:
            native.READS["native"] += 1
            return loaded
    raw = pd.read_csv(file_path, header=[0, 1, 2], index_col=0)
    keypoint_names = get_keypoint_names(raw)
    native.READS["pandas"] += 1
    return convert_lp_dlc(raw, keypoint_names), keypoint_names


def _candidate_paths(input_source) -> list | dict:
    """Normalize the input_source forms to either a sorted path list or a
    {camera: [paths]} dict."""
    if isinstance(input_source, str) and os.path.isdir(input_source):
        return sorted(
            os.path.join(input_source, f) for f in os.listdir(input_source)
        )
    if isinstance(input_source, list):
        return sorted(input_source)
    if isinstance(input_source, dict):
        return input_source
    raise ValueError(
        f"cannot interpret input_source of type {type(input_source).__name__}; "
        "pass a directory, a list of prediction files, or a "
        "{camera: [files]} mapping"
    )


def _paths_for_camera(file_paths, camera: str) -> list[str]:
    """Loadable files belonging to one camera (by filename substring for a
    flat list, by key for a dict)."""
    pool = file_paths if isinstance(file_paths, list) else file_paths.get(camera, [])
    return [
        fp
        for fp in pool
        if camera in os.path.basename(fp) and fp.endswith((".csv", ".slp"))
    ]


def format_data(
    input_source: str | list | dict,
    camera_names: list | None = None,
) -> tuple[list, list]:
    """Load prediction files into DataFrames.

    Args:
        input_source: a directory path, a list of file paths, or a dict
            mapping camera names to lists of file paths.
        camera_names: if given, files are matched to cameras by filename
            substring and the result is a list (per camera) of lists (per
            model); if None, the result is a flat list of model DataFrames.

    Returns:
        (input_dfs_list, keypoint_names)
    """
    file_paths = _candidate_paths(input_source)

    input_dfs_list: list = []
    keypoint_names = None

    if camera_names is None:
        for fp in file_paths:
            loaded = _load_one(fp)
            if loaded is None:
                continue
            df, keypoint_names = loaded
            input_dfs_list.append(df)
    else:
        for camera in camera_names:
            cam_paths = _paths_for_camera(file_paths, camera)
            if not cam_paths:
                raise FileNotFoundError(
                    f"camera '{camera}' matched nothing under {input_source}; "
                    "each prediction filename must contain its camera's name"
                )
            dfs_this_cam = []
            for fp in cam_paths:
                loaded = _load_one(fp)
                if loaded is None:
                    raise ValueError(f"cannot load predictions from {fp!r}")
                df, keypoint_names = loaded
                dfs_this_cam.append(df)
            input_dfs_list.append(dfs_this_cam)

        seed_counts = {len(dfs) for dfs in input_dfs_list}
        if len(seed_counts) > 1:
            detail = ", ".join(
                f"{cam}={len(dfs)}"
                for cam, dfs in zip(camera_names, input_dfs_list, strict=True)
            )
            logger.warning(f"cameras carry different ensemble sizes: {detail}")

    if len(input_dfs_list) == 0:
        raise FileNotFoundError(
            f"found no loadable prediction files in {input_source}"
        )
    assert keypoint_names is not None
    return input_dfs_list, keypoint_names
