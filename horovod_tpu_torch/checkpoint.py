"""Checkpoint / resume utilities.

Port of ``horovod_tpu/checkpoint.py``.  The reference packages three
conventions of Horovod's examples (SURVEY §5.4): rank-0-only writing,
resume = rank-0 restore + broadcast to all ranks including the resume
epoch, and optimizer-state rewrapping on load (``hvd.load_model``).

The on-disk format is the reference's numpy delta chain (``chain.json`` +
``shards.npz``, :func:`save_chain`), so each package reads the other's
chains.  Two deliberate divergences (ROADMAP Queue 3):

* **No orbax.**  :func:`save` commits a chain ``base`` under the same
  discipline as the reference's orbax save (world sidecar first, a
  dot-prefixed staging directory, one ``os.replace``); a legacy orbax
  epoch raises at :func:`restore`, naming the format.
* **bfloat16 leaves** are stored as the raw 2-byte records numpy calls
  ``V2``, as the reference's ``ml_dtypes.bfloat16`` leaves load back, and
  are reinterpreted by the restore template's dtype.

State trees are dicts, lists and tuples of tensors, numpy arrays and
Python scalars.  :func:`flatten_state` keys them with the strings
``jax.tree_util.keystr`` gives (``['params']['block_0']['kernel']``,
``[0]``, ``.field``), and copies every tensor to the host before it
returns, so a later in-place update cannot reach the snapshot.
:func:`save_model` stores an ``nn.Module`` as its flax-shaped tree
(:func:`horovod_tpu_torch.weights.to_flax`), so ``{"params": ...}``
chains cross packages for TransformerLM and ResNet.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import shutil
import sys
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import basics


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(directory), f"checkpoint-{epoch}")


# ------------------------------------------------------------ delta chains
# A committed ``checkpoint-N`` holds ``chain.json`` (manifest) and
# ``shards.npz`` (only the leaves whose bytes changed since the previous
# committed epoch).  A chain epoch is readable iff the manifest links
# ``prev`` hops back to a ``base`` epoch that still exists, and every link's
# shard file still matches the CRC32C its manifest recorded at commit.

CHAIN_MANIFEST = "chain.json"
CHAIN_SHARDS = "shards.npz"

# Staging paths owned by a LIVE async writer, keyed by epoch: a concurrent
# synchronous save()'s _clean_stale must not reap an in-flight commit.
_ACTIVE_STAGING: Dict[int, str] = {}

# numpy has no bfloat16: its leaves are stored as 2-byte raw records.
_BF16_RAW = np.dtype("V2")


class TornChainError(RuntimeError):
    """A chain checkpoint exists but one of its links (its base or an
    intermediate delta) is missing or unreadable, so the epoch cannot be
    reconstructed.  Resume paths catch this and fall back to the previous
    committed chain."""


def _key_entries(node) -> Optional[List[Tuple[str, Any]]]:
    """(key string piece, child) of a tree node as ``keystr`` prints them,
    in JAX's flattening order (dict keys sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def leaves_with_keys(tree, prefix: str = ""):
    """The (key string, leaf) pairs of a state tree, in JAX's flattening
    order, keyed as :func:`flatten_state` keys them; ``None`` is an empty
    subtree, as in JAX."""
    if tree is None:
        return
    entries = _key_entries(tree)
    if entries is None:
        yield prefix, tree
        return
    for piece, child in entries:
        yield from leaves_with_keys(child, prefix + piece)


def _to_host(leaf, pinned: bool):
    """A host copy of one leaf; a CUDA tensor's copy is queued
    (``non_blocking`` into pinned memory) and completed by the caller's
    synchronize."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
            out.copy_(t, non_blocking=pinned)
            return out
        return t.clone()
    return np.array(leaf)


def _as_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return t
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RAW)
    return t.numpy()


def flatten_state(state: Any) -> Dict[str, np.ndarray]:
    """Flatten a tree into ``{keystr(path): np.ndarray}``, the on-host
    snapshot form the delta writer diffs and stores.  Every leaf is
    copied: the device->host copies of CUDA tensors are queued into
    pinned buffers and have finished when this returns."""
    pairs = list(leaves_with_keys(state))
    cuda = any(isinstance(v, torch.Tensor) and v.is_cuda for _, v in pairs)
    host = [(k, _to_host(v, pinned=cuda)) for k, v in pairs]
    if cuda:
        torch.cuda.synchronize()
    return {k: _as_numpy(v) for k, v in host}


def _restore_leaf(key: str, like, value: np.ndarray):
    """``value`` in the kind of the template leaf ``like``: a tensor of its
    dtype on its device (``V2`` records reinterpreted as bfloat16), a
    Python scalar of its type, or the array as stored."""
    if isinstance(like, torch.Tensor):
        arr = np.asarray(value)
        if not arr.flags["C_CONTIGUOUS"] or not arr.flags["WRITEABLE"]:
            arr = np.array(arr)
        if arr.dtype == _BF16_RAW:
            if like.dtype != torch.bfloat16:
                raise ValueError(
                    f"chain checkpoint leaf {key} holds bfloat16 records, "
                    f"but the restore template's leaf is {like.dtype}")
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(
                f"chain checkpoint leaf {key} has shape {tuple(t.shape)}, "
                f"the restore template's {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(np.asarray(value).item())
    return value


def _rebuild(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure (dict key order included) with the leaf at
    each key string taken from ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _rebuild(v, values, f"{prefix}[{k!r}]"))
                          for k, v in tree.items())
    entries = _key_entries(tree)
    if entries is None:
        return values[prefix]
    kids = [_rebuild(child, values, prefix + piece)
            for piece, child in entries]
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def unflatten_like(like: Any, flat: Dict[str, Any]) -> Any:
    """Rebuild a tree with ``like``'s structure from a flat snapshot, each
    leaf in the kind of ``like``'s (:func:`_restore_leaf`).  The key sets
    must match exactly: a template drift (renamed or added leaves) is a
    structural error, not something to paper over."""
    pairs = list(leaves_with_keys(like))
    keys = [k for k, _ in pairs]
    missing = [k for k in keys if k not in flat]
    extra = sorted(set(flat) - set(keys))
    if missing or extra:
        raise ValueError(
            f"chain checkpoint does not match the restore template: "
            f"missing leaves {missing[:4]!r}, unexpected leaves "
            f"{extra[:4]!r}")
    return _rebuild(like, {k: _restore_leaf(k, v, flat[k])
                           for k, v in pairs})


def _chain_manifest(directory: str, epoch: int) -> Optional[dict]:
    p = os.path.join(checkpoint_path(directory, epoch), CHAIN_MANIFEST)
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_chain(directory: str, epoch: int) -> bool:
    """True when ``checkpoint-{epoch}`` is a committed chain directory
    (vs a legacy orbax tree or nothing at all)."""
    return _chain_manifest(directory, epoch) is not None


def chain_links(directory: str, epoch: int) -> Optional[List[int]]:
    """Epochs to replay, base first, to reconstruct chain ``epoch`` --
    or None when the chain is torn (a link missing, unreadable, cyclic,
    or not anchored to a base)."""
    links: List[int] = []
    e = epoch
    while True:
        m = _chain_manifest(directory, e)
        if m is None:
            return None
        links.append(e)
        if m.get("kind") == "base":
            return list(reversed(links))
        prev = m.get("prev", -1)
        # prev must strictly decrease -- anything else is corrupt/cyclic.
        if not isinstance(prev, int) or not 0 <= prev < e:
            return None
        e = prev


def _file_crc32c(path: str) -> int:
    """CRC32C of a file, read in place through a read-only map: a
    multi-GB shard costs no host copy (the reference reads it whole)."""
    from horovod_tpu_torch import wire
    if os.path.getsize(path) == 0:
        return wire.crc32c(b"")
    return wire.crc32c(np.memmap(path, dtype=np.uint8, mode="r"))


def _link_crc_ok(directory: str, epoch: int) -> bool:
    """Verify one chain link's shard file against the CRC32C its manifest
    recorded at commit.  Links from before the integrity trailer (no
    ``crc32c`` key) pass -- there is nothing to check them against."""
    m = _chain_manifest(directory, epoch)
    want = None if m is None else m.get("crc32c")
    if want is None:
        return True
    from horovod_tpu_torch import metrics
    try:
        got = _file_crc32c(os.path.join(checkpoint_path(directory, epoch),
                                        CHAIN_SHARDS))
    except OSError:
        return False
    if got != (want & 0xFFFFFFFF):
        metrics.registry.inc("ckpt.corrupt_links")
        return False
    return True


def _is_committed(directory: str, epoch: int) -> bool:
    """True when ``checkpoint-{epoch}`` is restorable: a legacy orbax dir
    (atomic-replace committed, hence complete; :func:`restore` names its
    format) or a chain dir whose links are all intact AND whose shard
    bytes still match the CRC32C recorded at commit."""
    if not os.path.isdir(checkpoint_path(directory, epoch)):
        return False
    if is_chain(directory, epoch):
        links = chain_links(directory, epoch)
        if links is None:
            return False
        return all(_link_crc_ok(directory, e) for e in links)
    return True


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise equality of two leaves (NaN payloads included), without
    the reference's ``tobytes`` copies."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.flags["C_CONTIGUOUS"] or not b.flags["C_CONTIGUOUS"]:
        return a.tobytes() == b.tobytes()
    return bool(np.array_equal(a.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)))


def save_chain(directory: str, flat: Dict[str, Any], epoch: int, *,
               prev_epoch: int = -1,
               prev_flat: Optional[Dict[str, Any]] = None,
               fault_hook=None) -> Dict[str, Any]:
    """Commit one chain epoch atomically: a full ``base`` when
    ``prev_flat`` is None (or the leaf set changed), else a ``delta``
    holding only the leaves whose bytes differ from ``prev_flat`` (the
    last COMMITTED snapshot, anchored at ``prev_epoch``).

    Commit discipline: world sidecar first, shards staged under a
    dot-prefixed dir ``latest_epoch`` can never match, one ``os.replace``
    to publish.  ``fault_hook`` (chaos drills) runs after the shards are
    staged but before the commit -- the worst place to die.

    Returns ``{"kind", "epoch", "nbytes", "shards", "total"}``.  The
    single-writer convention is the caller's job.
    """
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, epoch)
    if prev_flat is not None and set(prev_flat) != set(flat):
        prev_flat = None   # leaf set changed: a delta cannot express it
    if prev_flat is None:
        changed = sorted(flat)
        kind = "base"
    else:
        changed = sorted(
            k for k, v in flat.items()
            if not _same_bytes(np.asarray(v), np.asarray(prev_flat[k])))
        kind = "delta"
    staging = os.path.join(directory,
                           f".tmp-checkpoint-{epoch}-{os.getpid()}")
    _ACTIVE_STAGING[epoch] = staging
    try:
        # Sidecar before the commit: a resume that sees checkpoint-N can
        # always tell what world wrote it.
        try:
            world = {"world_size": basics.size(),
                     "process_count": basics.process_count()}
        except basics.NotInitializedError:
            world = None   # usable before init (tests, offline tools)
        if world is not None:
            _write_atomic(_world_meta_path(directory, epoch),
                          json.dumps(world))
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        shards = os.path.join(staging, CHAIN_SHARDS)
        np.savez(shards, **{k: np.asarray(flat[k]) for k in changed})
        shard_crc = _file_crc32c(shards)
        if fault_hook is not None:
            fault_hook()
        manifest = {"format": 1, "kind": kind, "epoch": epoch,
                    "prev": prev_epoch if kind == "delta" else -1,
                    "keys": sorted(flat), "shards": changed,
                    "crc32c": shard_crc}
        _write_atomic(os.path.join(staging, CHAIN_MANIFEST),
                      json.dumps(manifest))
        if os.path.isdir(path):
            shutil.rmtree(path)   # re-commit of the same epoch
        os.replace(staging, path)
    finally:
        _ACTIVE_STAGING.pop(epoch, None)
    nbytes = int(sum(np.asarray(flat[k]).nbytes for k in changed))
    return {"kind": kind, "epoch": epoch, "nbytes": nbytes,
            "shards": len(changed), "total": len(flat)}


def read_chain_state(directory: str, epoch: int) -> Dict[str, Any]:
    """Replay the base+delta chain ending at ``epoch`` into a flat
    snapshot.  Raises :class:`TornChainError` when the chain is torn."""
    links = chain_links(directory, epoch)
    if links is None:
        raise TornChainError(
            f"checkpoint-{epoch} in {directory!r} is a torn chain (a "
            f"base or delta link is missing); latest committed epoch "
            f"is {latest_epoch(directory)}")
    flat: Dict[str, Any] = {}
    for e in links:
        shard_path = os.path.join(checkpoint_path(directory, e),
                                  CHAIN_SHARDS)
        # End-to-end integrity: a shard whose bytes no longer match the
        # CRC32C recorded at commit makes the whole chain torn.
        if not _link_crc_ok(directory, e):
            raise TornChainError(
                f"checkpoint-{e} (link of chain {epoch}) in "
                f"{directory!r} is corrupt: shard CRC32C does not match "
                f"the manifest recorded at commit")
        try:
            with np.load(shard_path, allow_pickle=False) as z:
                for k in z.files:
                    flat[k] = z[k]
        except (OSError, ValueError, zipfile.BadZipFile) as exc:
            raise TornChainError(
                f"checkpoint-{e} (link of chain {epoch}) in "
                f"{directory!r} is unreadable: {exc}") from exc
    keys = _chain_manifest(directory, epoch)["keys"]
    missing = [k for k in keys if k not in flat]
    if missing:
        raise TornChainError(
            f"chain {epoch} in {directory!r} replayed without leaves "
            f"{missing[:4]!r} — base was overwritten by a narrower state")
    return {k: flat[k] for k in keys}


def _chain_leaf_meta(directory: str, epoch: int) -> Dict[str, Tuple]:
    """``{key: (shape, dtype descr)}`` of chain ``epoch``'s leaves, read
    from the ``.npy`` headers of its links (no data read)."""
    meta: Dict[str, Tuple] = {}
    for e in chain_links(directory, epoch) or []:
        path = os.path.join(checkpoint_path(directory, e), CHAIN_SHARDS)
        with zipfile.ZipFile(path) as z:
            for name in z.namelist():
                with z.open(name) as f:
                    fmt = np.lib.format
                    read_header = (fmt.read_array_header_1_0
                                   if fmt.read_magic(f) == (1, 0)
                                   else fmt.read_array_header_2_0)
                    shape, _, dtype = read_header(f)
                meta[name[:-4] if name.endswith(".npy") else name] = (
                    list(shape), np.lib.format.dtype_to_descr(dtype))
    return meta


def resolve_committed_epoch(directory: str, epoch: int) -> int:
    """``epoch`` if it is committed (legacy or intact chain), else the
    highest committed epoch below it, else -1.  The torn-tip fallback:
    rank 0 runs this before the restore broadcast so no rank ever starts
    restoring an epoch that cannot be read."""
    if epoch >= 0 and _is_committed(directory, epoch):
        return epoch
    best = -1
    if os.path.isdir(directory):
        for entry in os.listdir(directory):
            m = re.fullmatch(r"checkpoint-(\d+)", entry)
            if m and best < int(m.group(1)) < epoch and _is_committed(
                    directory, int(m.group(1))):
                best = int(m.group(1))
    return best


def save(directory: str, state: Any, epoch: int) -> Optional[str]:
    """Write a checkpoint on rank 0 only; other ranks no-op.

    ``state`` is any tree (e.g. ``{"params": ..., "opt_state": ...}``).
    The epoch is committed as a chain ``base``: the world-size sidecar,
    then the shards staged in a dot-prefixed directory that
    :func:`latest_epoch` can never match, then one ``os.replace``.  A
    crash mid-save leaves debris (cleaned up by the next save), never a
    half-written directory a resume would restore from.
    """
    return _save(directory, state, epoch)


def _save(directory: str, state: Any, epoch: int,
          spec: Optional["OptimizerSpec"] = None) -> Optional[str]:
    """:func:`save`, with ``spec`` written beside the epoch after the
    stale-debris sweep and before the commit.  (The reference writes
    ``save_model``'s spec before ``save``, whose sweep then reaps it as an
    orphan sidecar: ROADMAP Queue 3.)"""
    if basics.rank() != 0:
        return None
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    _clean_stale(directory)
    if spec is not None:
        # The spec lands BEFORE the checkpoint commits: a concurrent
        # directory-only load_model that sees checkpoint-N must always
        # find N's spec.
        _write_atomic(_optimizer_spec_path(directory, epoch),
                      spec.to_json())
    save_chain(directory, flatten_state(state), epoch)
    return checkpoint_path(directory, epoch)


def _write_atomic(path: str, text: str) -> None:
    """Publish ``text`` at ``path`` via a same-directory temp file and
    ``os.replace``, so no reader ever sees a partially-written file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _clean_stale(directory: str) -> None:
    """Remove debris a mid-save crash can leave behind: uncommitted
    staging directories, half-written sidecar temp files, and orphan
    sidecars whose checkpoint never committed.  Staging dirs registered
    by a live async writer (``_ACTIVE_STAGING``) are in flight, not
    stale."""
    entries = set(os.listdir(directory))
    active = {os.path.basename(p) for p in _ACTIVE_STAGING.values()}
    active_epochs = {f"checkpoint-{e}" for e in _ACTIVE_STAGING}
    for entry in entries:
        p = os.path.join(directory, entry)
        if re.fullmatch(r"\.tmp-checkpoint-\d+-\d+", entry):
            if entry not in active:
                shutil.rmtree(p, ignore_errors=True)
        elif re.fullmatch(
                r"checkpoint-\d+\.(world|optimizer)\.json\.tmp", entry):
            try:
                os.remove(p)
            except OSError:
                pass
        else:
            m = re.fullmatch(r"(checkpoint-\d+)\.(world|optimizer)\.json",
                             entry)
            if (m and m.group(1) not in entries
                    and m.group(1) not in active_epochs):
                try:
                    os.remove(p)
                except OSError:
                    pass


def _world_meta_path(directory: str, epoch: int) -> str:
    return checkpoint_path(directory, epoch) + ".world.json"


def saved_world_size(directory: str, epoch: int) -> int:
    """World size recorded when checkpoint ``epoch`` was written, or -1
    for checkpoints predating the sidecar (or an unreadable one)."""
    p = _world_meta_path(directory, epoch)
    try:
        with open(p) as f:
            return int(json.load(f).get("world_size", -1))
    except (OSError, ValueError):
        return -1


def _sharded_leaf_path(tree) -> Optional[str]:
    """Key of the first leaf laid out across ranks, or None.  torch's one
    sharded-array type is ``DTensor``; a leaf with a ``Shard`` placement is
    bound to a specific world shape and cannot survive an elastic
    world-size change.  A plain per-rank slice (tensor, pipeline or
    expert parallelism) looks replicated here (ROADMAP Queue 3)."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:   # a torch built without distributed
        return None
    for key, leaf in leaves_with_keys(tree):
        if isinstance(leaf, DTensor) and any(
                p.is_shard() for p in leaf.placements):
            return key
    return None


def latest_epoch(directory: str) -> int:
    """Highest epoch with a COMMITTED checkpoint in ``directory``, or -1.

    Only committed checkpoint directories count: staging debris, sidecars
    and stray files are skipped, and a chain epoch counts only when every
    link back to its base is intact, so a resume racing a crashed delta
    writer falls back past the torn tip.
    """
    if not os.path.isdir(directory):
        return -1
    best = -1
    for entry in os.listdir(directory):
        m = re.fullmatch(r"checkpoint-(\d+)", entry)
        if m and int(m.group(1)) > best and _is_committed(
                directory, int(m.group(1))):
            best = int(m.group(1))
    return best


def restore(directory: str, epoch: int, like: Any) -> Any:
    """Restore the checkpoint for ``epoch`` with the structure of ``like``.

    A chain epoch replays its base+delta links; raises
    :class:`TornChainError` if a link is missing.  A legacy orbax epoch
    (the JAX package's ``save``) raises ``ValueError`` naming the format:
    the port reads chains only.
    """
    import time
    t0 = time.perf_counter()
    if not is_chain(directory, epoch):
        raise ValueError(
            f"checkpoint-{epoch} in {directory!r} is not a chain "
            f"checkpoint ({CHAIN_MANIFEST} + {CHAIN_SHARDS}): a legacy "
            "orbax tree, written by horovod_tpu.checkpoint.save, which "
            "horovod_tpu_torch does not read (no orbax); re-save it as a "
            "chain (horovod_tpu.checkpoint.save_chain)")
    out = unflatten_like(like, read_chain_state(directory, epoch))
    from horovod_tpu_torch import metrics
    metrics.registry.observe("ckpt.restore_seconds",
                             time.perf_counter() - t0)
    return out


_FACTORY_ROOT = "torch.optim"


@dataclasses.dataclass
class OptimizerSpec:
    """Serializable optimizer identity, the counterpart of the reference's
    optax spec (``checkpoint.py:458``): a ``torch.optim`` class by its
    import path (``"torch.optim.SGD"``) with its keyword arguments, or a
    name resolved from ``custom_objects`` at build time.  ``build(params)``
    rebuilds the optimizer over ``params``.  torch has no chain of
    transformations, so a spec holds one step (:meth:`chain` raises)."""

    steps: List[Tuple[str, Dict[str, Any]]]

    @classmethod
    def of(cls, factory: str, **kwargs) -> "OptimizerSpec":
        return cls([(factory, kwargs)])

    @classmethod
    def chain(cls, *steps) -> "OptimizerSpec":
        raise TypeError(
            "OptimizerSpec.chain: a torch.optim optimizer is one class, "
            "not a chain of transformations; declare one step with "
            "OptimizerSpec.of(factory, **kwargs)")

    @classmethod
    def from_optimizer(cls, optimizer) -> "OptimizerSpec":
        """The spec of an optimizer instance (or of a
        ``DistributedOptimizer`` around one): its class and ``defaults``.
        A class of ``torch.optim`` is recorded by its public path."""
        base = next(c for c in type(optimizer).__mro__
                    if c.__module__ != "horovod_tpu_torch.optimizer")
        public = getattr(torch.optim, base.__name__, None) is base
        path = (f"{_FACTORY_ROOT}.{base.__name__}" if public
                else f"{base.__module__}.{base.__qualname__}")
        return cls.of(path, **dict(optimizer.defaults))

    def to_json(self) -> str:
        return json.dumps({"steps": [[f, kw] for f, kw in self.steps]})

    @classmethod
    def from_json(cls, text: str) -> "OptimizerSpec":
        data = json.loads(text)
        return cls([(f, kw) for f, kw in data["steps"]])

    def build(self, params, custom_objects: Optional[Dict[str, Any]] = None):
        if len(self.steps) != 1:
            raise TypeError(
                f"OptimizerSpec with {len(self.steps)} steps: a "
                "torch.optim optimizer is one class, not a chain of "
                "transformations")
        factory, kwargs = self.steps[0]
        if custom_objects and factory in custom_objects:
            fn = custom_objects[factory]
        else:
            mod_name, _, attr = factory.rpartition(".")
            # The spec file sits on disk next to the checkpoint; resolving
            # arbitrary dotted paths from it would hand a tampered
            # directory code execution at resume.  Only the torch.optim
            # namespace auto-imports -- everything else must come through
            # the caller's custom_objects.
            if mod_name != _FACTORY_ROOT and not mod_name.startswith(
                    _FACTORY_ROOT + "."):
                raise ValueError(
                    f"optimizer factory {factory!r} is neither a "
                    f"{_FACTORY_ROOT}.* path nor in custom_objects "
                    f"{sorted(custom_objects or {})}; pass it via "
                    "load_model(custom_objects={...})")
            fn = getattr(importlib.import_module(mod_name), attr)
        return fn(params, **kwargs)


def _as_optimizer_spec(optimizer) -> OptimizerSpec:
    if isinstance(optimizer, OptimizerSpec):
        return optimizer
    if (isinstance(optimizer, tuple) and len(optimizer) == 2
            and isinstance(optimizer[0], str)):
        return OptimizerSpec([(optimizer[0], dict(optimizer[1]))])
    if isinstance(optimizer, list):
        return OptimizerSpec.chain(*optimizer)
    if isinstance(optimizer, torch.optim.Optimizer):
        return OptimizerSpec.from_optimizer(optimizer)
    raise TypeError(
        "save_model(optimizer=...) takes an OptimizerSpec, a "
        "(factory, kwargs) tuple or a torch.optim.Optimizer")


def _optimizer_spec_path(directory: str, epoch: int) -> str:
    return checkpoint_path(directory, epoch) + ".optimizer.json"


def model_state(model: torch.nn.Module, optimizer=None) -> Dict[str, Any]:
    """The training state of ``model`` (and ``optimizer``) as the chain
    stores it: ``{"params": ..., "opt_state": optimizer.state_dict()}``,
    ``params`` the module's flax-shaped tree (:func:`weights.to_flax
    <horovod_tpu_torch.weights.to_flax>`), plus ``batch_stats`` for its
    buffers when it has any.  The tensors are the live ones: the tree is
    a restore template, or the state to snapshot (``flatten_state``
    copies).  torch fills an optimizer's state at its first step, so a
    template taken before it lacks that state: fill it first (zero SGD
    momentum buffers give SGD's first update bit for bit)."""
    from horovod_tpu_torch import weights
    tree = {"params": weights.to_flax(dict(model.named_parameters()))}
    buffers = dict(model.named_buffers())
    if buffers:
        tree["batch_stats"] = weights.to_flax(buffers)
    if optimizer is not None:
        tree["opt_state"] = optimizer.state_dict()
    return tree


def load_model_state(model: torch.nn.Module, optimizer,
                     state: Dict[str, Any]) -> None:
    """Load a :func:`model_state` tree (as restored) into ``model`` and,
    when given, ``optimizer``."""
    from horovod_tpu_torch import weights
    flat = weights.from_flax(state["params"])
    flat.update(weights.from_flax(state.get("batch_stats", {})))
    with torch.no_grad():
        model.load_state_dict(flat, strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["opt_state"])


def _broadcast_text(text: Optional[str], root_rank: int, name: str) -> str:
    """Broadcast a variable-length UTF-8 string from ``root_rank``:
    length first (fixed-shape negotiated broadcast), then the payload."""
    from horovod_tpu_torch.ops import eager
    data = (text or "").encode("utf-8")
    n = int(eager.broadcast(torch.tensor(len(data), dtype=torch.int64),
                            root_rank, name=f"{name}.len"))
    buf = torch.zeros(n, dtype=torch.uint8)
    if basics.rank() == root_rank and n:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out = eager.broadcast(buf, root_rank, name=f"{name}.bytes")
    return out.numpy().tobytes().decode("utf-8")


def _broadcast_int(value: int, root_rank: int, name: str) -> int:
    from horovod_tpu_torch.ops import eager
    return int(eager.broadcast(torch.tensor(value, dtype=torch.int64),
                               root_rank, name=name))


def save_model(directory: str, params: Any, opt_state: Any,
               epoch: int, optimizer=None) -> Optional[str]:
    """Save a full training state (params + optimizer state) under the
    ``{"params", "opt_state"}`` convention :func:`load_model` restores.
    Rank-0-only like :func:`save`.

    ``params`` is an ``nn.Module`` (stored as its flax-shaped tree, plus
    ``batch_stats`` for its buffers) or a tree; ``opt_state`` a
    ``torch.optim.Optimizer`` (its ``state_dict()``) or a tree.
    ``optimizer`` (an :class:`OptimizerSpec`, a ``(factory, kwargs)``
    tuple or an optimizer instance) additionally persists the optimizer
    *identity* next to the checkpoint, enabling :func:`load_model` to
    rebuild it from the directory alone."""
    spec = _as_optimizer_spec(optimizer) if optimizer is not None else None
    state = (model_state(params) if isinstance(params, torch.nn.Module)
             else {"params": params})
    state["opt_state"] = (opt_state.state_dict()
                          if isinstance(opt_state, torch.optim.Optimizer)
                          else opt_state)
    return _save(directory, state, epoch, spec)


_OPT_STATE_KEY = re.compile(r"\['opt_state'\]\['state'\]\[(\d+)\]\['(.+)'\]")


def _opt_state_like(optimizer, meta: Dict[str, Any]) -> Dict[str, Any]:
    """The restore template of ``optimizer``'s ``state_dict()`` as the
    checkpoint holds it: torch fills a state lazily, at the first step,
    so the per-parameter entries are built from the chain's leaf headers
    (``meta``: ``{key: [shape, dtype descr]}``), on their parameters'
    devices; ``param_groups`` is the fresh optimizer's."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state: Dict[int, Dict[str, Any]] = {}
    for key, (shape, descr) in meta.items():
        m = _OPT_STATE_KEY.fullmatch(key)
        if m is None:
            continue
        i = int(m.group(1))
        dtype = np.dtype(descr)
        tdtype = (torch.bfloat16 if dtype == _BF16_RAW
                  else torch.from_numpy(np.zeros(0, dtype)).dtype)
        device = params[i].device if i < len(params) else "cpu"
        state.setdefault(i, {})[m.group(2)] = torch.empty(
            tuple(shape), dtype=tdtype, device=device)
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def load_model(directory: str, model: torch.nn.Module, optimizer=None, *,
               root_rank: int = 0, average: bool = True, compression=None,
               custom_objects=None, **distributed_kwargs):
    """One-call resume with the optimizer re-wrapped distributed -- the
    reference's ``hvd.load_model`` (``checkpoint.py:634``): restore the
    saved model, reconstruct its optimizer from the file, wrap it in
    :func:`horovod_tpu_torch.DistributedOptimizer`, broadcast.

    Args:
      directory: checkpoint directory written by :func:`save_model`.
      model: the ``nn.Module`` to load into (torch builds a model from
        code, so it is the restore skeleton the reference derives from
        metadata); its parameters are restored in place.
      optimizer: the PLAIN ``torch.optim`` optimizer over ``model``'s
        parameters, or an :class:`OptimizerSpec`.  **Omit it** to rebuild
        the optimizer from the spec persisted by ``save_model(...,
        optimizer=...)``; ``custom_objects`` resolves factory names
        outside ``torch.optim`` then.
      average / compression / distributed_kwargs: forwarded to
        ``DistributedOptimizer`` (e.g. ``eager=True``).

    Returns ``(model, distributed_optimizer, resume_epoch)``;
    ``resume_epoch`` is -1 (fresh state, still broadcast from
    ``root_rank``) when the directory holds no checkpoint -- starting
    fresh requires ``optimizer``.
    """
    from horovod_tpu_torch.compression import NoneCompressor
    from horovod_tpu_torch.optimizer import DistributedOptimizer

    if compression is None:
        compression = NoneCompressor
    if isinstance(optimizer, OptimizerSpec):
        optimizer = optimizer.build(model.parameters(), custom_objects)
    # Agree on the epoch ONCE: the optimizer reconstruction, the state
    # template and the restore all use it, so a checkpoint landing
    # concurrently cannot split them across two epochs.
    epoch = latest_epoch(directory) if basics.rank() == root_rank else -1
    epoch = _broadcast_int(epoch, root_rank, "ckpt.spec_epoch")
    if optimizer is None:
        if epoch < 0:
            raise FileNotFoundError(
                f"load_model: no checkpoint in {directory!r} to "
                "reconstruct from; pass optimizer= to start fresh")
        spec_text = None
        if basics.rank() == root_rank:
            p = _optimizer_spec_path(directory, epoch)
            spec_text = open(p).read() if os.path.exists(p) else ""
        spec_text = _broadcast_text(spec_text, root_rank, "ckpt.optspec")
        if not spec_text:
            raise FileNotFoundError(
                f"load_model: checkpoint-{epoch} in {directory!r} was "
                "saved without an optimizer spec (save_model's "
                "optimizer= argument); pass optimizer= explicitly")
        optimizer = OptimizerSpec.from_json(spec_text).build(
            model.parameters(), custom_objects)
    opt_like = optimizer.state_dict()
    if epoch >= 0:
        meta = None
        if basics.rank() == root_rank:
            tip = resolve_committed_epoch(directory, epoch)
            meta = json.dumps(_chain_leaf_meta(directory, tip)
                              if is_chain(directory, tip) else {})
        meta = json.loads(_broadcast_text(meta, root_rank, "ckpt.oskel"))
        opt_like = _opt_state_like(optimizer, meta)
    like = model_state(model)
    like["opt_state"] = opt_like
    state, epoch = restore_and_broadcast(directory, like,
                                         root_rank=root_rank, epoch=epoch)
    tx = DistributedOptimizer(optimizer, average=average,
                              compression=compression, **distributed_kwargs)
    load_model_state(model, tx if epoch >= 0 else None, state)
    return model, tx, epoch


def _broadcast_state(state: Any, root_rank: int = 0,
                    name_prefix: str = "ckpt.broadcast") -> Any:
    """Broadcast a tree from ``root_rank`` over the negotiated eager plane
    (the reference's ``broadcast_parameters``, ``jax/__init__.py:519``):
    tensors and numpy arrays leaf by leaf, Python scalars wrapped in a
    tensor and restored to their type; other leaves pass through."""
    from horovod_tpu_torch.ops import eager
    pairs = list(leaves_with_keys(state))
    handles = []
    for i, (_, leaf) in enumerate(pairs):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
        elif isinstance(leaf, np.ndarray) and leaf.dtype != _BF16_RAW:
            t = torch.from_numpy(np.ascontiguousarray(leaf))
        elif isinstance(leaf, (bool, int, float)):
            # A Python float is a double: float32 would round it.
            t = torch.tensor(leaf, dtype=torch.float64
                             if isinstance(leaf, float) else None)
        else:
            handles.append(None)
            continue
        handles.append(eager.broadcast_async(t, root_rank,
                                             name=f"{name_prefix}.{i}"))
    out = {}
    for (key, leaf), h in zip(pairs, handles):
        if h is None:
            out[key] = leaf
            continue
        got = eager.synchronize(h)
        if isinstance(leaf, torch.Tensor):
            out[key] = got
        elif isinstance(leaf, np.ndarray):
            out[key] = got.numpy()
        else:
            out[key] = type(leaf)(got.item())
    return _rebuild(state, out)


def restore_and_broadcast(directory: str, like: Any,
                          root_rank: int = 0,
                          epoch: Optional[int] = None,
                          optional_keys: Tuple[str, ...] = ()
                          ) -> Tuple[Any, int]:
    """Resume protocol: the resume epoch is agreed by broadcasting rank
    0's scan; rank 0 restores; state is broadcast so all ranks start
    identical.  Every agreement rides the negotiated eager plane
    (``ops/eager.broadcast``), so a membership change landing mid-restore
    completes RETRYABLE like one landing mid-train.

    Returns ``(state, resume_epoch)``; ``resume_epoch`` is -1 (and
    ``state`` is ``like``, broadcast from root) when no checkpoint
    exists.  Pass an explicit ``epoch`` (already agreed across ranks) to
    restore that checkpoint instead of re-scanning.

    ``optional_keys`` (``like`` must be a dict): top-level template keys
    tolerated as absent on disk; the presence set is agreed across ranks
    before the value broadcast and the template's values pass through.
    """
    if epoch is None:
        epoch = latest_epoch(directory) if basics.rank() == root_rank else -1
        epoch = _broadcast_int(epoch, root_rank, "ckpt.resume_epoch")
    if epoch >= 0:
        # Torn-tip fallback, agreed BEFORE any value broadcast: rank 0
        # validates the chosen epoch is committed and every rank pivots
        # to the same fallback.
        tip = (resolve_committed_epoch(directory, epoch)
               if basics.rank() == root_rank else -1)
        tip = _broadcast_int(tip, root_rank, "ckpt.chain_tip")
        if tip != epoch:
            print(
                f"horovod_tpu checkpoint: checkpoint-{epoch} in "
                f"{directory!r} is torn or missing; falling back to "
                + (f"committed checkpoint-{tip}" if tip >= 0
                   else "fresh state (no committed checkpoint)"),
                file=sys.stderr)
        epoch = tip
    if epoch >= 0:
        # Elastic resume: replicated state re-broadcasts from root at ANY
        # world size; a DTensor shard is bound to the old world shape and
        # fails with a named leaf.
        saved = (saved_world_size(directory, epoch)
                 if basics.rank() == root_rank else -1)
        saved = _broadcast_int(saved, root_rank, "ckpt.world_size")
        cur = basics.size()
        if saved >= 0 and saved != cur:
            bad = _sharded_leaf_path(like)
            if bad is not None:
                raise ValueError(
                    f"restore_and_broadcast: checkpoint-{epoch} in "
                    f"{directory!r} was saved at world size {saved} but "
                    f"the job is now size {cur}, and template leaf "
                    f"{bad!r} is sharded across devices — sharded state "
                    "cannot be re-laid-out across a different world; "
                    "only replicated state survives an elastic "
                    "world-size change (see docs/elasticity.md)")
            print(
                f"horovod_tpu checkpoint: checkpoint-{epoch} was written "
                f"at world size {saved}; restoring into world size {cur} "
                f"— replicated state re-broadcast from rank {root_rank}",
                file=sys.stderr)
    if optional_keys and not isinstance(like, dict):
        raise TypeError(
            "optional_keys needs a dict template (top-level keys)")
    defaults = {}
    if optional_keys and epoch >= 0:
        present = 0
        if basics.rank() == root_rank:
            leaf_keys = _chain_manifest(directory, epoch)["keys"] \
                if is_chain(directory, epoch) else []
            present = sum(
                1 << i for i, k in enumerate(optional_keys)
                if any(s.startswith(f"['{k}']") for s in leaf_keys))
        present = _broadcast_int(present, root_rank, "ckpt.optional_keys")
        missing = {k for i, k in enumerate(optional_keys)
                   if not (present >> i) & 1}
        defaults = {k: like[k] for k in optional_keys
                    if k in missing and k in like}
        like = {k: v for k, v in like.items() if k not in missing}
    state = like
    if epoch >= 0 and basics.rank() == root_rank:
        state = restore(directory, epoch, like)
    if defaults:
        state = {**state, **defaults}
    state = _broadcast_state(state, root_rank, name_prefix="ckpt.broadcast")
    return state, epoch
