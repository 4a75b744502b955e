"""Fingerprints, the self-validating blob and the capture record.

Port of ``veles_tpu/aot/export.py``. The reference serializes each
steady-state computation as ``jax.export`` StableHLO. Its counterpart
on the card is a captured CUDA graph, which cannot be serialized, and
the kernels bound through ``ctypes`` are invisible to ``torch.export``.
So an AOT entry of the port is a **capture record**: a JSON document
in the reference's self-validating blob (magic + one header line with
crc32 and length), under the port's own magic, so a reference
StableHLO blob is a clean miss and never a parse. A record holds the
entry's name and fingerprint, the shapes and dtypes of its static
inputs, its in-place (donation) signature, the kernel libraries it
launches with their keys, and the launch tally of one replay. A record
never changes which kernels run: the capture is always made in the
process, and the record only says that it is planned (warmed before
traffic) and what it must come out as.

Fingerprints keep the reference's canonical JSON over a computation's
identity (config or spec stack, parameter shapes and dtypes, dtype
policy, slab shapes, mesh) plus the environment, which is the port's
own: the device's name and compute capability (``cpu`` off the card,
so a CPU record never hits on the card), the torch and CUDA versions,
the device count, the kernel sources' key and the format version.
Values that ride as tensors (weights, learning rates) are not hashed:
a weight swap keeps every record valid.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("veles_aot")

#: capture-record and bundle-manifest format version
FORMAT_VERSION = 1

#: the port's blob magic (the reference's is ``VAOT1``)
BLOB_MAGIC = b"VTCR1\n"


class AotUnavailable(Exception):
    """A record could not be read or does not hold (the caller counts
    a miss or a fallback and captures; never fatal)."""


# -- fingerprints ----------------------------------------------------------

def environment_signature(device=None) -> Dict[str, Any]:
    """The runtime's part of every fingerprint for work on ``device``
    (None: the current CUDA device, or the CPU where there is none)."""
    from veles_tpu_torch.ops import _build
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(index)
        place = {"platform": "cuda",
                 "device": torch.cuda.get_device_name(index),
                 "capability": "%d.%d" % (major, minor)}
    else:
        place = {"platform": dev.type, "device": dev.type,
                 "capability": None}
    return dict(place, torch=torch.__version__, cuda=torch.version.cuda,
                n_devices=torch.cuda.device_count()
                if torch.cuda.is_available() else 0,
                kernels=_build.sources_key(), format=FORMAT_VERSION)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _canonical(obj: Any) -> Any:
    """JSON-serializable canonical form (tuples -> lists, dtypes ->
    names, arrays -> content digests)."""
    if isinstance(obj, dict):
        return {str(k): _canonical(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (np.dtype, torch.dtype)):
        return _dtype_name(obj)
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        # constants baked into a computation hash by content
        return {"__array__": [list(obj.shape), obj.dtype.name,
                              hashlib.sha256(np.ascontiguousarray(
                                  obj).tobytes()).hexdigest()[:16]]}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _tree_leaves(tree: Any) -> Iterable[Any]:
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for node in tree:
            yield from _tree_leaves(node)
    elif tree is not None:
        yield tree


def tree_signature(tree: Any) -> List[List[Any]]:
    """Shapes and dtypes of a tree of tensors or arrays (dict keys in
    sorted order, as ``jax.tree.leaves``); values excluded."""
    out = []
    for leaf in _tree_leaves(tree):
        if not hasattr(leaf, "dtype"):
            leaf = np.asarray(leaf)
        out.append([list(leaf.shape), _dtype_name(leaf.dtype)])
    return out


def fingerprint(kind: str, payload: Dict[str, Any], device=None) -> str:
    """Canonical config hash of one computation family on ``device``."""
    doc = {"kind": kind, "env": environment_signature(device),
           "payload": _canonical(payload)}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


# -- blob format -----------------------------------------------------------

def pack_blob(payload: bytes, meta: Dict[str, Any]) -> bytes:
    """Magic + one JSON header line (crc32 + length + meta) + payload."""
    header = dict(meta)
    header["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
    header["nbytes"] = len(payload)
    return BLOB_MAGIC + json.dumps(header, sort_keys=True).encode() + \
        b"\n" + payload


def unpack_blob(blob: bytes) -> Tuple[bytes, Dict[str, Any]]:
    """Inverse of :func:`pack_blob`; raises :class:`AotUnavailable` on
    any corruption (magic, header, length, crc)."""
    if not blob.startswith(BLOB_MAGIC):
        raise AotUnavailable("bad magic")
    rest = blob[len(BLOB_MAGIC):]
    nl = rest.find(b"\n")
    if nl < 0:
        raise AotUnavailable("truncated header")
    try:
        meta = json.loads(rest[:nl])
    except ValueError as e:
        raise AotUnavailable("corrupt header: %s" % e)
    if not isinstance(meta, dict):
        raise AotUnavailable("corrupt header: not an object")
    payload = rest[nl + 1:]
    if len(payload) != meta.get("nbytes"):
        raise AotUnavailable("length mismatch (%d != %s)"
                             % (len(payload), meta.get("nbytes")))
    if (zlib.crc32(payload) & 0xFFFFFFFF) != meta.get("crc32"):
        raise AotUnavailable("crc mismatch")
    return payload, meta


# -- capture records -------------------------------------------------------

#: the fields two records of one entry must agree on
RECORD_FIELDS = ("inputs", "donation", "kernels", "launches", "captured")


def specs_of(tensors: Iterable[Any]) -> List[List[Any]]:
    """[[shape], dtype] of each static input."""
    return [[list(t.shape), _dtype_name(t.dtype)] for t in tensors]


def kernels_of(launches: Dict[str, int]) -> Dict[str, str]:
    """{library: key} of the libraries a launch tally names."""
    from veles_tpu_torch.ops import _build
    libs = sorted({_build.LIBRARY_OF[name] for name, n in launches.items()
                   if n})
    return {lib: _build.library_key(lib) for lib in libs}


def make_record(name: str, fp: str, inputs: List[List[Any]],
                donation: Iterable[str] = (),
                launches: Optional[Dict[str, int]] = None,
                captured: bool = True) -> Dict[str, Any]:
    """A capture record's document. ``launches``: the tally of one
    replay (None where the entry runs eagerly: nothing is replayed)."""
    launches = None if launches is None else \
        {k: int(v) for k, v in sorted(launches.items()) if v}
    return {"name": name, "fingerprint": fp, "format": FORMAT_VERSION,
            "inputs": [[list(s), str(d)] for s, d in inputs],
            "donation": list(donation),
            "kernels": kernels_of(launches or {}),
            "launches": launches, "captured": bool(captured)}


def pack_record(record: Dict[str, Any]) -> bytes:
    payload = json.dumps(record, sort_keys=True).encode()
    return pack_blob(payload, {"name": record["name"],
                               "fingerprint": record["fingerprint"],
                               "format": FORMAT_VERSION})


def unpack_record(blob: bytes) -> Dict[str, Any]:
    """The record in ``blob``; :class:`AotUnavailable` on a foreign or
    corrupt blob."""
    payload, meta = unpack_blob(blob)
    if meta.get("format") != FORMAT_VERSION:
        raise AotUnavailable("record format %r, expected %d"
                             % (meta.get("format"), FORMAT_VERSION))
    try:
        record = json.loads(payload)
    except ValueError as e:
        raise AotUnavailable("corrupt record: %s" % e)
    if not isinstance(record, dict) or \
            any(k not in record for k in RECORD_FIELDS):
        raise AotUnavailable("record lacks its fields")
    return record


def record_differences(planned: Dict[str, Any],
                       fresh: Dict[str, Any]) -> List[str]:
    """The fields in which a fresh capture disagrees with its record."""
    return [k for k in RECORD_FIELDS if planned.get(k) != fresh.get(k)]


# -- the trainers' and the loader's fingerprints ---------------------------

def _mesh_shape(mesh) -> Optional[List[Any]]:
    if mesh is None:
        return None
    return sorted([str(k), int(v)] for k, v in dict(mesh.shape).items())


def _fused_trainer_payload(trainer) -> Dict[str, Any]:
    """The FusedClassifierTrainer part of a config hash, one builder
    for the step and loader-step fingerprints."""
    return {
        "specs": trainer.specs,
        "params": tree_signature(trainer.params),
        "compute_dtype": _dtype_name(trainer.compute_dtype),
        "skip_nonfinite": trainer.nan_policy == "skip",
        "kernel_impl": trainer.kernel_impl,
        "mesh": _mesh_shape(trainer.mesh),
        "tensor_parallel": bool(trainer.tensor_parallel),
        "cuda_graphs": bool(trainer._graphs_on),
    }


def fused_trainer_fingerprint(trainer) -> str:
    return fingerprint("fused_step_many", _fused_trainer_payload(trainer),
                       trainer.device)


def transformer_trainer_fingerprint(trainer) -> str:
    par = getattr(trainer, "_par", None)
    return fingerprint("lm_step_many", {
        "config": dataclasses.asdict(trainer.config),
        "params": tree_signature(trainer.params),
        "skip_nonfinite": trainer.nan_policy == "skip",
        "seq_axis": getattr(par, "seq_name", None),
        "mesh": _mesh_shape(trainer.mesh),
    }, trainer.device)


def normalizer_signature(normalizer):
    """Canonical identity of a loader normalizer (its arrays hash by
    content), or ``False`` when it cannot be fingerprinted (the caller
    then keeps out of the plan)."""
    if normalizer is None:
        return None
    try:
        state = vars(normalizer)
    except TypeError:
        return False
    doc: Dict[str, Any] = {"class": type(normalizer).__name__}
    for key in sorted(state):
        value = state[key]
        if isinstance(value, (np.ndarray, torch.Tensor)):
            doc[key] = value
        elif isinstance(value, (int, float, str, bool, type(None))):
            doc[key] = value
        elif isinstance(value, (list, tuple)) and all(
                isinstance(v, (int, float, str, bool)) for v in value):
            doc[key] = list(value)
        elif hasattr(value, "shape") and hasattr(value, "dtype"):
            doc[key] = np.asarray(value)
        else:
            return False
    return doc


def loader_fingerprint(trainer, normalizer, mbs: int, dataset,
                       variant: str) -> Optional[str]:
    """A loader step's config hash, or None when its normalizer cannot
    be fingerprinted."""
    norm_sig = normalizer_signature(normalizer)
    if norm_sig is False:
        return None
    payload = _fused_trainer_payload(trainer)
    payload.update({"normalizer": norm_sig, "mbs": int(mbs),
                    "dataset_dtype": _dtype_name(dataset.dtype)})
    return fingerprint("loader_" + variant, payload, trainer.device)
