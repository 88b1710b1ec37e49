"""Carry states between the JAX package and this port.

The ``*_to_torch`` functions take a state of the JAX package whose leaves
are numpy arrays (``np.asarray`` of each JAX array) — any object with the
state's field names — and return the port's state as tensors on `device`.
The ``*_to_numpy`` functions go back: the port's state type with numpy
leaves, in field order, ready for the JAX package's constructors after
``jnp.asarray``. numpy has no bfloat16 of its own, so bf16 leaves come back
as float32 (exact). The server's inputs cross the same way: a `Vocabulary`
(its uint32 words become int32 tensors of the same bits), a `TreeVocabulary`
(numpy in both packages), a `ServerConfig` and a `PipelineConfig` (field by
field, the nested configs included). A TSDF volume crosses whole: its pool
arrays and its host tables. A camera crosses by its fields: any object that
carries a JAX camera's field values (numpy or numbers) and its class name
becomes the port's camera of that name, and back. The front-end's state
crosses by its fields too: a `WindowState`, a `Preintegrated` (stacked or
not), a `CamPriorFactor`, FAST `Keypoints`, a BRIEF pattern, and an
`AgentConfig` with its `CameraConfig` and `ImuNoise` (to the port's
dataclasses, and back as a dict of plain fields). Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from . import camera as _camera
from .dense.estimator import DenseConfig, DenseState
from .mapping.tsdf import ChunkPool, TsdfConfig, TsdfVolume
from .ops.depth_filter import FilterState
from .ops.hamming import descriptors_to_torch
from .server.optimizer import PoseGraphEdges, PoseGraphNodes
from .server.pipeline import PipelineConfig
from .server.posegraph import ServerConfig
from .server.vocab import TreeVocabulary, Vocabulary
from .ops.fast import Keypoints
from .utils.config import AgentConfig, CameraConfig
from .vio.imu import ImuNoise, Preintegrated
from .vio.window_ba import CamPriorFactor, WindowState

__all__ = ["array_to_torch", "tensor_to_numpy",
           "dense_state_to_torch", "dense_state_to_numpy",
           "filter_state_to_torch", "filter_state_to_numpy",
           "nodes_to_torch", "nodes_to_numpy", "edges_to_torch", "edges_to_numpy",
           "vocabulary_to_torch", "tree_vocabulary_to_torch",
           "server_config_to_torch", "pipeline_config_to_torch",
           "tsdf_volume_to_torch", "tsdf_volume_to_numpy",
           "camera_to_torch", "camera_to_numpy",
           "window_state_to_torch", "window_state_to_numpy",
           "preintegrated_to_torch", "preintegrated_to_numpy",
           "cam_prior_to_torch", "cam_prior_to_numpy",
           "keypoints_to_torch", "keypoints_to_numpy",
           "brief_pattern_to_torch", "brief_pattern_to_numpy",
           "agent_config_to_torch", "agent_config_to_dict"]


def array_to_torch(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array (bf16 arrays included, as ml_dtypes stores them) ->
    tensor on `device`, optionally cast to `dtype`."""
    a = np.array(a, copy=True, order="C")   # the port may update in place
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host; bf16 becomes float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def filter_state_to_torch(s, device) -> FilterState:
    return FilterState(*(array_to_torch(getattr(s, f), device, torch.float32)
                         for f in FilterState._fields))


def filter_state_to_numpy(s: FilterState) -> FilterState:
    return FilterState(*(tensor_to_numpy(x) for x in s))


def dense_state_to_torch(s, device) -> DenseState:
    """A JAX `DenseState` with numpy leaves (sparse_bias may be None)."""
    bias = s.sparse_bias
    return DenseState(
        ref_img=array_to_torch(s.ref_img, device),
        grad=array_to_torch(s.grad, device),
        mean_cost=array_to_torch(s.mean_cost, device),
        count=array_to_torch(s.count, device),
        sparse_bias=None if bias is None else array_to_torch(bias, device),
        penalty=array_to_torch(s.penalty, device),
        filt=filter_state_to_torch(s.filt, device),
        num_frames=array_to_torch(s.num_frames, device, torch.int32))


def dense_state_to_numpy(s: DenseState) -> DenseState:
    return DenseState(
        ref_img=tensor_to_numpy(s.ref_img),
        grad=tensor_to_numpy(s.grad),
        mean_cost=tensor_to_numpy(s.mean_cost),
        count=tensor_to_numpy(s.count),
        sparse_bias=None if s.sparse_bias is None else tensor_to_numpy(s.sparse_bias),
        penalty=tensor_to_numpy(s.penalty),
        filt=filter_state_to_numpy(s.filt),
        num_frames=tensor_to_numpy(s.num_frames))


def nodes_to_torch(s, device) -> PoseGraphNodes:
    return PoseGraphNodes(
        yaw=array_to_torch(s.yaw, device), pr=array_to_torch(s.pr, device),
        t=array_to_torch(s.t, device),
        valid=array_to_torch(s.valid, device, torch.bool),
        fixed=array_to_torch(s.fixed, device, torch.bool))


def nodes_to_numpy(s: PoseGraphNodes) -> PoseGraphNodes:
    return PoseGraphNodes(*(tensor_to_numpy(x) for x in s))


def edges_to_torch(s, device) -> PoseGraphEdges:
    """Edge indices become int64 (torch's index type)."""
    return PoseGraphEdges(
        i=array_to_torch(s.i, device, torch.int64),
        j=array_to_torch(s.j, device, torch.int64),
        t_ij=array_to_torch(s.t_ij, device), yaw_ij=array_to_torch(s.yaw_ij, device),
        t_weight=array_to_torch(s.t_weight, device),
        yaw_weight=array_to_torch(s.yaw_weight, device),
        valid=array_to_torch(s.valid, device, torch.bool),
        huber=array_to_torch(s.huber, device))


def edges_to_numpy(s: PoseGraphEdges) -> PoseGraphEdges:
    """Edge indices go back as int32, the JAX package's index type."""
    arrs = [tensor_to_numpy(x) for x in s]
    return PoseGraphEdges(arrs[0].astype(np.int32), arrs[1].astype(np.int32), *arrs[2:])


def vocabulary_to_torch(v, device) -> Vocabulary:
    """A JAX `Vocabulary` with numpy leaves (uint32 `level_desc`, `weights`)."""
    return Vocabulary(tuple(descriptors_to_torch(np.asarray(d), device) for d in v.level_desc),
                      array_to_torch(v.weights, device, torch.float32), int(v.k), int(v.levels))


def tree_vocabulary_to_torch(t) -> TreeVocabulary:
    """A JAX `TreeVocabulary` (its arrays copied; the port keeps the tree in
    numpy and moves it to a device in `SparseBowDatabase`)."""
    return TreeVocabulary(*(np.array(x, copy=True) if isinstance(x, np.ndarray) else x
                            for x in (getattr(t, f) for f in TreeVocabulary._fields)))


_CAMERAS = {c.__name__: c for c in (_camera.PinholeCamera, _camera.EquidistantCamera,
                                    _camera.MeiCamera, _camera.ScaramuzzaCamera)}


def camera_to_torch(cam, device, kind: str | None = None):
    """A JAX camera with numpy leaves (any object with the model's fields:
    `fx, fy, cx, cy` and `dist` or `k`, `xi`, or `poly, inv_poly, c, d, e`,
    with `width` and `height`) -> the port's camera of the same class name on
    `device`. `kind` names the class where `type(cam).__name__` does not."""
    cls = _CAMERAS[kind or type(cam).__name__]
    vals = [getattr(cam, f) for f in cls._fields]
    return cls(*(int(v) if f in ("width", "height")
                 else array_to_torch(np.asarray(v, np.float32), device)
                 for f, v in zip(cls._fields, vals)))


def camera_to_numpy(cam):
    """The port's camera with numpy leaves, in field order: the JAX package's
    class of the same name takes them after ``jnp.asarray``."""
    return type(cam)(*(tensor_to_numpy(v) if isinstance(v, torch.Tensor) else v for v in cam))


def _copy_config(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


def server_config_to_torch(cfg) -> ServerConfig:
    """A JAX `ServerConfig`, copied field by field."""
    return _copy_config(ServerConfig, cfg)


def pipeline_config_to_torch(cfg) -> PipelineConfig:
    """A JAX `PipelineConfig` with its nested `ServerConfig`, `DenseConfig`
    and `TsdfConfig`, copied field by field."""
    nested = {"server": server_config_to_torch(cfg.server),
              "dense": _copy_config(DenseConfig, cfg.dense),
              "tsdf": _copy_config(TsdfConfig, cfg.tsdf)}
    return PipelineConfig(**{f.name: nested.get(f.name, getattr(cfg, f.name))
                             for f in dataclasses.fields(PipelineConfig)})


# the host-side attributes of a TSDF volume, shared by both packages
_VOLUME_TABLES = ("capacity", "coords_np", "occupied_np", "slot_of", "free", "dirty",
                  "max_chunks_per_frame", "dropped_chunks")


def tsdf_volume_to_torch(vol, device) -> TsdfVolume:
    """A JAX `TsdfVolume` (its pool leaves anything `np.asarray` takes) ->
    the port's volume on `device`, with copies of the pool and of the host
    tables (chunk coordinates, occupancy, coordinate -> slot map, free list,
    dirty set, drop count)."""
    out = TsdfVolume(_copy_config(TsdfConfig, vol.cfg), device=device)
    out.pool = ChunkPool(*(array_to_torch(x, device, torch.float32) for x in vol.pool))
    for name in _VOLUME_TABLES:
        setattr(out, name, _copy_table(getattr(vol, name)))
    return out


def tsdf_volume_to_numpy(vol: TsdfVolume) -> types.SimpleNamespace:
    """The port's volume as numpy, under the JAX `TsdfVolume`'s attribute
    names: `cfg` (a dict of `TsdfConfig` fields), `pool` (a `ChunkPool` of
    numpy arrays) and copies of the host tables. Setting each attribute on a
    JAX volume (the pool after `jnp.asarray`) restores it there."""
    return types.SimpleNamespace(
        cfg=dataclasses.asdict(vol.cfg),
        pool=ChunkPool(*(tensor_to_numpy(x) for x in vol.pool)),
        **{name: _copy_table(getattr(vol, name)) for name in _VOLUME_TABLES})


def _copy_table(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, dict):
        return {tuple(int(x) for x in key): int(s) for key, s in v.items()}
    if isinstance(v, (list, set)):
        return type(v)(int(x) for x in v)
    return v


_BOOL_FIELDS = ("kf_valid", "lm_valid", "valid")


def _fields_to_torch(cls, s, device):
    return cls(*(array_to_torch(getattr(s, f), device,
                                torch.bool if f in _BOOL_FIELDS else torch.float32)
                 for f in cls._fields))


def _fields_to_numpy(s):
    return type(s)(*(tensor_to_numpy(x) for x in s))


def window_state_to_torch(s, device) -> WindowState:
    """A JAX `WindowState` with numpy leaves (float32 states, bool masks)."""
    return _fields_to_torch(WindowState, s, device)


def window_state_to_numpy(s: WindowState) -> WindowState:
    return _fields_to_numpy(s)


def preintegrated_to_torch(p, device) -> Preintegrated:
    """A JAX `Preintegrated` (one interval or stacked) with numpy leaves."""
    return _fields_to_torch(Preintegrated, p, device)


def preintegrated_to_numpy(p: Preintegrated) -> Preintegrated:
    return _fields_to_numpy(p)


def cam_prior_to_torch(p, device) -> CamPriorFactor:
    """A JAX `CamPriorFactor` with numpy leaves."""
    return _fields_to_torch(CamPriorFactor, p, device)


def cam_prior_to_numpy(p: CamPriorFactor) -> CamPriorFactor:
    return _fields_to_numpy(p)


def keypoints_to_torch(k, device) -> Keypoints:
    """JAX FAST `Keypoints` with numpy leaves."""
    return _fields_to_torch(Keypoints, k, device)


def keypoints_to_numpy(k: Keypoints) -> Keypoints:
    return _fields_to_numpy(k)


def brief_pattern_to_torch(pattern, device) -> torch.Tensor:
    """A (bits, 4) BRIEF test pattern as the int32 tensor the port's
    `compute_brief` accepts as `pattern`."""
    return array_to_torch(np.asarray(pattern, np.int32), device)


def brief_pattern_to_numpy(pattern: torch.Tensor) -> np.ndarray:
    """A pattern tensor back as the (bits, 4) int32 array both packages'
    `compute_brief` and `save_brief_pattern_yaml` take."""
    return tensor_to_numpy(pattern).astype(np.int32)


def agent_config_to_torch(cfg) -> AgentConfig:
    """A JAX `AgentConfig` (any object with its fields, its `camera` and
    `imu` included) as the port's, field by field."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(AgentConfig)}
    fields["camera"] = _copy_config(CameraConfig, cfg.camera)
    fields["imu"] = ImuNoise(*(getattr(cfg.imu, f) for f in ImuNoise._fields))
    return AgentConfig(**fields)


def agent_config_to_dict(cfg: AgentConfig) -> dict:
    """The port's `AgentConfig` as plain fields: a dict whose `camera` and
    `imu` are dicts too. The JAX package's config is
    ``AgentConfig(camera=CameraConfig(**d["camera"]), imu=ImuNoise(**d["imu"]), **rest)``."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(AgentConfig)}
    d["camera"] = dataclasses.asdict(cfg.camera)
    d["imu"] = dict(cfg.imu._asdict())
    return d
