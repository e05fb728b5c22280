"""MarkerArray: named-axis 5-D container for ensemble pose predictions.

Axes are fixed as ``(models, cameras, frames, keypoints, fields)``; fields are
named (e.g. ``["x", "y", "likelihood"]``). Same exterior contract as the
reference container (reference: eks/marker_array.py:15-266) so downstream
smoothers can slice/stack without positional-axis bookkeeping; the
implementation here is original.

The container is host-side and NumPy-backed: it exists to organise I/O and
packaging. Device compute takes raw arrays extracted from it; nothing in the
hot path loops over MarkerArray. This is the PyTorch port's own copy of
``eks_tpu/marker_array.py``, NumPy only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "MarkerArray",
    "input_dfs_to_markerArray",
    "mA_to_stacked_array",
    "stacked_array_to_mA",
]

# canonical axis order for every MarkerArray
_AXES = ("models", "cameras", "frames", "keypoints", "fields")
_FIELD_AXIS = 4


def _axis_index(axis: str) -> int:
    """Resolve a named axis to its position, or fail loudly."""
    assert axis in _AXES, (
        f"Unknown axis {axis!r}; valid axes are {list(_AXES)}."
    )
    return _AXES.index(axis)


def _select(arr: np.ndarray, axis: int, idxs: Sequence[int]) -> np.ndarray:
    """Gather ``idxs`` along ``axis`` via basic fancy indexing (axis is kept)."""
    key = [slice(None)] * arr.ndim
    key[axis] = list(idxs)
    return arr[tuple(key)]


class MarkerArray:
    """A 5-D array of shape (n_models, n_cameras, n_frames, n_keypoints, n_fields)
    with named axes and named fields.

    Construct from an array, an empty shape, or by cloning another instance.
    """

    def __init__(
        self,
        array: np.ndarray | None = None,
        shape: tuple | None = None,
        data_fields: list[str] | None = None,
        marker_array: Optional["MarkerArray"] = None,
        dtype: type = np.float32,
    ):
        if marker_array is not None:
            assert isinstance(marker_array, MarkerArray), (
                "The marker_array argument only accepts another MarkerArray."
            )
            # clone (deep-copies the buffer); `array` may override the payload
            self.array = (
                np.array(marker_array.array, dtype=dtype) if array is None else array
            )
            self.data_fields = (
                list(marker_array.data_fields)
                if data_fields is None and marker_array.data_fields is not None
                else data_fields
            )
        elif array is not None:
            assert isinstance(array, np.ndarray), (
                "MarkerArray wraps NumPy arrays only."
            )
            assert array.ndim == 5, (
                f"Need a 5-D array ordered as {_AXES}; got ndim={array.ndim}."
            )
            self.array = array
            self.data_fields = data_fields
        elif shape is not None:
            assert len(shape) == 5, (
                f"A MarkerArray shape has exactly 5 entries ({_AXES})."
            )
            self.array = np.zeros(tuple(int(s) for s in shape), dtype=dtype)
            self.data_fields = data_fields
        else:
            raise AssertionError(
                "Nothing to build from: pass one of array / shape / marker_array."
            )

        (
            self.n_models,
            self.n_cameras,
            self.n_frames,
            self.n_keypoints,
            self.n_fields,
        ) = self.array.shape
        self.axis_map = {name: i for i, name in enumerate(_AXES)}

    # ------------------------------------------------------------------ #
    def _derive(self, array, fields: list[str] | None = None) -> "MarkerArray":
        """New instance sharing this one's field names unless overridden."""
        return MarkerArray(
            array,
            data_fields=self.data_fields if fields is None else fields,
        )

    @property
    def shape(self) -> tuple:
        return tuple(self.array.shape)

    def get_array(self, squeeze: bool = False) -> np.ndarray:
        """Underlying array, with singleton axes squeezed out if requested."""
        return np.squeeze(self.array) if squeeze else self.array

    def _field_positions(self, fields: Sequence[str]) -> list[int]:
        for f in fields:
            assert f in (self.data_fields or []), (
                f"No field named {f!r} here; this array carries {self.data_fields}."
            )
        return [self.data_fields.index(f) for f in fields]

    # ------------------------------------------------------------------ #
    def slice(self, axis: str, indices) -> "MarkerArray":
        """Take ``indices`` along a named axis; the axis is kept (len >= 1)."""
        ax = _axis_index(axis)
        if isinstance(indices, (int, np.integer)):
            indices = [int(indices)]
        return self._derive(_select(self.array, ax, indices))

    def slice_fields(self, *fields: str) -> "MarkerArray":
        """Keep only the named fields (in the order given)."""
        idxs = self._field_positions(fields)
        return self._derive(
            _select(self.array, _FIELD_AXIS, idxs), fields=list(fields)
        )

    # ------------------------------------------------------------------ #
    @staticmethod
    def stack(others: Sequence["MarkerArray"], axis: str) -> "MarkerArray":
        """Concatenate multiple MarkerArrays along a named axis."""
        assert len(others) > 0, "stack needs a non-empty sequence of MarkerArrays."
        ax = _axis_index(axis)
        first = others[0]
        want = np.delete(np.asarray(first.shape), ax)
        for other in others[1:]:
            assert isinstance(other, MarkerArray), (
                "stack only combines MarkerArray instances."
            )
            have = np.delete(np.asarray(other.shape), ax)
            assert (want == have).all(), (
                f"Incompatible shapes along {axis!r}: the non-stacked axes differ "
                f"({first.shape} vs {other.shape})."
            )
        return first._derive(
            np.concatenate([o.array for o in others], axis=ax)
        )

    def stack_fields(*marker_arrays: "MarkerArray") -> "MarkerArray":
        """Concatenate along the fields axis, merging field names."""
        assert len(marker_arrays) > 0, (
            "stack_fields needs at least one MarkerArray."
        )
        first = marker_arrays[0]
        merged_fields: list[str] = []
        for other in marker_arrays:
            assert isinstance(other, MarkerArray), (
                "stack_fields only combines MarkerArray instances."
            )
            assert other.shape[:_FIELD_AXIS] == first.shape[:_FIELD_AXIS], (
                f"Field-stacking requires matching leading axes; "
                f"got {first.shape[:4]} vs {other.shape[:4]}."
            )
            assert other.data_fields is not None, (
                "Every input to stack_fields must carry field names."
            )
            merged_fields.extend(other.data_fields)
        return first._derive(
            np.concatenate([o.array for o in marker_arrays], axis=_FIELD_AXIS),
            fields=merged_fields,
        )

    def reorder_data_fields(self, new_order: list[str]) -> "MarkerArray":
        """Permute the fields axis to match ``new_order``."""
        assert set(new_order) == set(self.data_fields or []), (
            f"reorder needs a permutation of {self.data_fields}; got {new_order}."
        )
        idxs = self._field_positions(new_order)
        return MarkerArray(
            marker_array=self,
            array=_select(self.array, _FIELD_AXIS, idxs),
            data_fields=list(new_order),
        )

    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:
        dims = ", ".join(
            f"{n}={s}" for n, s in zip(_AXES, self.array.shape, strict=True)
        )
        return f"MarkerArray({dims}, data_fields={self.data_fields}, type=NumPy)"


# ---------------------------------------------------------------------- #
# converters
# ---------------------------------------------------------------------- #
def input_dfs_to_markerArray(
    input_dfs_list,
    bodypart_list: list[str],
    camera_names: list[str],
    data_fields: list[str] = ["x", "y", "likelihood"],
) -> MarkerArray:
    """Build a (models, cameras, frames, keypoints, fields) MarkerArray from a
    per-camera list of per-model DataFrames with flat ``{kp}_{field}`` columns.

    Same exterior contract as the reference converter
    (eks/marker_array.py:269-299); here the per-(keypoint, field) column loop is
    replaced by one vectorized column gather per DataFrame.
    """
    n_models = len(input_dfs_list[0])
    n_frames = input_dfs_list[0][0].shape[0]
    wanted = [f"{kp}_{f}" for kp in bodypart_list for f in data_fields]

    planes = np.empty(
        (n_models, len(camera_names), n_frames, len(bodypart_list), len(data_fields))
    )
    for c in range(len(camera_names)):
        for m in range(n_models):
            # one (T, K*F) gather, then fold the trailing axis into (K, F);
            # loaders emit columns in exactly this order, so the common case
            # skips the label-based reindex entirely
            df = input_dfs_list[c][m]
            if list(df.columns) == wanted:
                block = df.to_numpy()
            else:
                block = df[wanted].to_numpy()
            planes[m, c] = block.reshape(
                n_frames, len(bodypart_list), len(data_fields)
            )
    return MarkerArray(planes, data_fields=data_fields)


def mA_to_stacked_array(marker_array: MarkerArray, keypoint_idx: int) -> np.ndarray:
    """Flatten one keypoint of a single-model MarkerArray to (n_frames, n_cameras*n_fields),
    with per-frame layout [cam0 fields..., cam1 fields..., ...].

    Same exterior contract as the reference (eks/marker_array.py:302-324).
    """
    _, n_cameras, n_frames, n_keypoints, n_fields = marker_array.shape
    assert 0 <= keypoint_idx < n_keypoints, (
        f"keypoint index {keypoint_idx} outside [0, {n_keypoints})."
    )
    # (cameras, frames, fields) for model 0, then frames-major flatten
    one_kp = marker_array.array[0, :, :, keypoint_idx, :]
    return np.moveaxis(one_kp, 0, 1).reshape(n_frames, n_cameras * n_fields)


def stacked_array_to_mA(
    stacked: np.ndarray,
    n_cameras: int,
    data_fields: list[str],
) -> MarkerArray:
    """Inverse of :func:`mA_to_stacked_array` for a single keypoint:
    (n_frames, n_cameras*n_fields) -> MarkerArray (1, n_cameras, n_frames, 1, n_fields).
    """
    n_frames, total = stacked.shape
    assert total % n_cameras == 0, (
        f"Cannot split {total} stacked columns across {n_cameras} cameras evenly."
    )
    per_cam = stacked.reshape(n_frames, n_cameras, total // n_cameras)
    arr = np.moveaxis(per_cam, 1, 0)[:, :, None, :][None]
    return MarkerArray(arr, data_fields=data_fields)
