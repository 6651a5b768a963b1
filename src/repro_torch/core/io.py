"""Persistent index artifacts — one ``.npz`` with an embedded manifest, in
the reference's format (``src/repro/core/io.py``, schema v4), so that each
package reads the other's files.

The ``.npz`` holds a ``manifest`` entry (a JSON document: format magic,
schema version, shapes, PQ geometry, provenance) beside the arrays under
the reference's member names: ``base``, ``neighbors``, ``hubs``, ``key``,
``hier{i}_{neighbors,nodes,slot}``, ``hier_entry``, ``hier_levels``,
``pq_codebooks``, ``pq_codes``, ``pq_rotation``, ``meta_<name>``. A v4
artifact may shard the base into sibling ``<stem>.shard###.npy`` files
(``save_index(..., shard_rows=K)``), which the disk tier maps
(:func:`open_base_shards`). Every write is atomic (temporary file, fsync,
rename), the shards first and the ``.npz`` that makes them live last.
Loading validates magic, version, shapes and shards and raises
:class:`CorruptArtifactError` for anything it cannot decode. A
pre-manifest ``{base, neighbors, metric}`` file loads as version 0.

Arrays are numpy on disk and CPU tensors in a loaded
:class:`IndexArtifact`; :meth:`IndexArtifact.to_searcher` puts them on the
device the caller names. bf16 shards are uint16 bits on disk (the
reference's own bf16 shards load as 2-byte void and are viewed the same
way), so the port needs no ``ml_dtypes``.

The PRNG key. The reference persists a ``jax.random`` key; the port's
``Searcher`` takes an int ``rng_seed``. The key travels as an opaque
uint32 payload with its ``key_impl`` tag and is written back unchanged. A
searcher with no loaded key writes ``key_impl="raw"`` with payload ``[0,
rng_seed]``, which is ``jax.random.PRNGKey(rng_seed)``, so the reference
loads the same key. On load, a payload ``[0, s]`` gives ``rng_seed = s``
and any other payload gives the crc32 of its bytes. The port's random draws
differ from the reference's in any case.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from ..baselines.pq import PQIndex
from .base_store import DTYPES as STORE_DTYPES
from .base_store import bf16_bits, bf16_to_f32
from .graph_index import (
    DEFAULT_N_HUBS,
    HnswIndex,
    degree_distribution,
    hub_vertices,
    in_degree_distribution,
)


class CorruptArtifactError(ValueError):
    """An on-disk index artifact that cannot be decoded: a truncated write,
    a torn copy, a missing or damaged shard, a manifest that disagrees with
    its arrays, or a schema this build does not read. A ValueError, so
    callers that catch those still catch it."""


FORMAT_MAGIC = "repro/index-artifact"
# v2: + hubs and degree statistics; v3: + metadata columns; v4: + base
# shards and the OPQ rotation. Older versions load unchanged.
ARTIFACT_VERSION = 4

_M32 = 0xFFFFFFFF


def _np(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


def _cpu(a, dtype: torch.dtype) -> torch.Tensor:
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32,
                torch.uint8: np.uint8}[dtype]
    return torch.from_numpy(np.array(a, dtype=np_dtype, order="C"))


def key_payload(rng_seed: int) -> np.ndarray:
    """The uint32 payload of ``jax.random.PRNGKey(rng_seed)``: ``[0,
    rng_seed]``."""
    if not 0 <= rng_seed <= _M32:
        raise ValueError(f"rng_seed must lie in [0, 2**32) to persist as a key, got {rng_seed}")
    return np.array([0, rng_seed], np.uint32)


def seed_from_key(payload) -> int:
    """A persisted key payload -> the port's ``rng_seed``: ``[0, s]`` gives
    ``s``, any other payload the crc32 of its bytes."""
    p = np.ascontiguousarray(payload, dtype=np.uint32)
    if p.shape == (2,) and int(p[0]) == 0:
        return int(p[1])
    return zlib.crc32(p.tobytes())


@dataclasses.dataclass
class IndexArtifact:
    """Everything a Searcher is made of, in one persistable bundle.
    ``key`` is the uint32 payload and ``key_impl`` its tag ("raw" or
    "typed"), both None where the artifact carries no key."""

    base: torch.Tensor            # (n, d) float32
    neighbors: torch.Tensor       # (n, R) int32 flat adjacency (hier: layer 0)
    metric: str
    key: np.ndarray | None = None
    key_impl: str | None = None
    hierarchy: HnswIndex | None = None
    pq: PQIndex | None = None
    provenance: dict = dataclasses.field(default_factory=dict)
    version: int = ARTIFACT_VERSION
    # (H,) int32 top in-degree vertices, descending (None: derived on save)
    hubs: torch.Tensor | None = None
    degree_stats: dict = dataclasses.field(default_factory=dict)
    # optional metadata columns (name -> (n,) numpy array) for filters
    metadata: dict | None = None

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def d(self) -> int:
        return self.base.shape[1]

    @property
    def rng_seed(self) -> int:
        """The port's seed for this artifact's key (0 without one)."""
        return 0 if self.key is None else seed_from_key(self.key)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_searcher(cls, searcher, provenance: dict | None = None) -> "IndexArtifact":
        """Snapshot a live port Searcher: flat graph, hierarchy, the PQ table
        it serves without training, hubs, metadata, and its key (the loaded
        payload, else ``PRNGKey(rng_seed)``'s)."""
        key, impl = searcher.key if searcher.key is not None else (
            key_payload(searcher.rng_seed), "raw")
        return cls(base=searcher.base, neighbors=searcher.neighbors,
                   metric=searcher.metric, key=key, key_impl=impl,
                   hierarchy=searcher.hierarchy, pq=searcher.pq,
                   provenance=dict(provenance or {}), hubs=searcher.hubs,
                   metadata=searcher.metadata)

    @classmethod
    def from_build(cls, base, result, metric: str, rng_seed: int = 0,
                   metadata: dict | None = None) -> "IndexArtifact":
        """Package a port ``GraphBuilder`` output; provenance is the build
        report's summary."""
        return cls(base=base, neighbors=result.graph.neighbors, metric=metric,
                   key=key_payload(rng_seed), key_impl="raw",
                   hierarchy=result.hierarchy, pq=result.pq,
                   provenance={"build_report": result.report.summary()},
                   hubs=result.hubs, metadata=metadata)

    def to_searcher(self, device="cuda"):
        """The port Searcher on ``device``: the same adjacency, hierarchy,
        PQ table (attached, never retrained), hubs, metadata and key."""
        from .convert import hnsw_from_numpy, pq_index_from_numpy, searcher_from_numpy

        hier = self.hierarchy
        if hier is not None:
            hier = hnsw_from_numpy([_np(a) for a in hier.layers_neighbors],
                                   [_np(a) for a in hier.layers_nodes],
                                   [_np(a) for a in hier.layers_slot],
                                   _np(hier.entry_point), _np(hier.levels), device)
        pq = self.pq
        if pq is not None:
            pq = pq_index_from_numpy(_np(pq.codebooks), _np(pq.codes),
                                     None if pq.rotation is None else _np(pq.rotation),
                                     device)
        searcher = searcher_from_numpy(
            _np(self.base), _np(self.neighbors), metric=self.metric,
            rng_seed=self.rng_seed, pq=pq, hierarchy=hier,
            hubs=None if self.hubs is None else _np(self.hubs),
            metadata=self.metadata, device=device)
        if self.key is not None:
            searcher.key = (np.array(self.key, np.uint32), self.key_impl)
        return searcher


def normalize_path(path: str) -> str:
    """np.savez appends .npz to a path without it; normalize up front so the
    path reported is the file written or read."""
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_write(path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, fsync, rename:
    readers see the old complete file or the new one."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_write_npy(path: str, arr: np.ndarray) -> None:
    """np.save through a temporary file + fsync + rename."""
    _atomic_write(path, lambda f: np.save(f, arr))


def shard_file_names(path: str, count: int) -> list[str]:
    """The sibling shard basenames ``save_index(shard_rows=...)`` writes for
    an artifact at ``path``: ``<stem>.shard###.npy``."""
    stem = os.path.basename(normalize_path(path))[: -len(".npz")]
    return [f"{stem}.shard{i:03d}.npy" for i in range(count)]


def save_index(path: str, artifact: IndexArtifact, *, shard_rows: int = 0,
               shard_dtype: str = "f32") -> str:
    """Write one .npz (manifest + arrays); returns the normalized path.
    ``shard_rows > 0`` moves the base into row-partitioned sibling ``.npy``
    shards of at most that many rows, stored as ``shard_dtype`` (``f32``,
    or ``bf16`` as round-to-nearest-even uint16 bits)."""
    path = normalize_path(path)
    if shard_dtype not in STORE_DTYPES:
        raise ValueError(f"unknown shard_dtype {shard_dtype!r}; one of {tuple(STORE_DTYPES)}")
    base_np = _np(artifact.base, np.float32)
    neighbors = _np(artifact.neighbors, np.int32)
    arrays: dict[str, np.ndarray] = {"neighbors": neighbors}
    shards_entry = None
    if shard_rows > 0:
        starts = list(range(0, base_np.shape[0], shard_rows))
        files = shard_file_names(path, len(starts))
        rows = []
        dirname = os.path.dirname(os.path.abspath(path)) or "."
        for fname, start in zip(files, starts):
            chunk = base_np[start:start + shard_rows]
            chunk = bf16_bits(chunk) if shard_dtype == "bf16" else np.ascontiguousarray(chunk)
            _atomic_write_npy(os.path.join(dirname, fname), chunk)
            rows.append(int(chunk.shape[0]))
        shards_entry = {"files": files, "rows": rows, "dtype": shard_dtype}
    else:
        arrays["base"] = base_np
    hubs = artifact.hubs
    if hubs is None:
        hubs = hub_vertices(neighbors, DEFAULT_N_HUBS)
    arrays["hubs"] = _np(hubs, np.int32)
    degree_stats = artifact.degree_stats or {
        "out": degree_distribution(neighbors),
        "in": in_degree_distribution(neighbors),
    }
    manifest = {
        "format": FORMAT_MAGIC,
        "version": ARTIFACT_VERSION,
        "metric": artifact.metric,
        "n": int(base_np.shape[0]),
        "d": int(base_np.shape[1]),
        "degree": int(neighbors.shape[1]),
        "n_hubs": int(arrays["hubs"].shape[0]),
        "degree_stats": degree_stats,
        "num_layers": 0,
        "pq": None,
        "key_impl": None,
        "metadata": [],
        "shards": shards_entry,
        "provenance": artifact.provenance,
    }
    if artifact.metadata:
        n = int(base_np.shape[0])
        for name in sorted(artifact.metadata):
            col = np.asarray(artifact.metadata[name])
            if col.ndim != 1 or col.shape[0] != n:
                raise ValueError(f"metadata column {name!r} must be ({n},), got {col.shape}")
            arrays[f"meta_{name}"] = col
            manifest["metadata"].append(name)
    if artifact.key is not None:
        arrays["key"] = np.asarray(artifact.key, np.uint32)
        manifest["key_impl"] = artifact.key_impl or "raw"
    hier = artifact.hierarchy
    if hier is not None:
        manifest["num_layers"] = hier.num_layers
        arrays["hier_entry"] = _np(hier.entry_point, np.int32)
        arrays["hier_levels"] = _np(hier.levels, np.int32)
        for i in range(hier.num_layers):
            arrays[f"hier{i}_neighbors"] = _np(hier.layers_neighbors[i], np.int32)
            arrays[f"hier{i}_nodes"] = _np(hier.layers_nodes[i], np.int32)
            arrays[f"hier{i}_slot"] = _np(hier.layers_slot[i], np.int32)
    pq = artifact.pq
    if pq is not None:
        manifest["pq"] = {"m": int(pq.M), "k": int(pq.K), "rotation": pq.rotation is not None}
        arrays["pq_codebooks"] = _np(pq.codebooks, np.float32)
        arrays["pq_codes"] = _np(pq.codes, np.uint8)
        if pq.rotation is not None:
            arrays["pq_rotation"] = _np(pq.rotation, np.float32)
    _atomic_write(path, lambda f: np.savez(f, manifest=np.array(json.dumps(manifest)),
                                           **arrays))
    return path


def _load_legacy(blob, path: str) -> IndexArtifact:
    """The pre-manifest serve format: {base, neighbors, metric} only."""
    missing = {"base", "neighbors", "metric"} - set(blob.files)
    if missing:
        raise ValueError(f"{path} is neither an index artifact (no manifest) nor the "
                         f"legacy flat-graph format (missing {sorted(missing)})")
    neighbors = blob["neighbors"]
    return IndexArtifact(
        base=_cpu(blob["base"], torch.float32), neighbors=_cpu(neighbors, torch.int32),
        metric=str(blob["metric"]), provenance={"legacy": True}, version=0,
        hubs=hub_vertices(neighbors, DEFAULT_N_HUBS),
        degree_stats={"out": degree_distribution(neighbors),
                      "in": in_degree_distribution(neighbors)},
    )


def load_index(path: str) -> IndexArtifact:
    """Read an artifact back, validating magic, version, shapes and shards.
    Raises :class:`CorruptArtifactError` (never a raw numpy or zipfile
    traceback) for a file it cannot decode."""
    path = normalize_path(path)
    try:
        blob = np.load(path, allow_pickle=False)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError, ValueError) as e:
        raise CorruptArtifactError(
            f"{path}: not a readable index artifact ({e}) — truncated or "
            "corrupted write? (save_index writes atomically via temp file + "
            "rename, so a crash mid-save cannot produce this)") from e
    try:
        return _decode_artifact(blob, path)
    except (zipfile.BadZipFile, zlib.error, EOFError, KeyError,
            json.JSONDecodeError) as e:
        raise CorruptArtifactError(
            f"{path}: index artifact is damaged mid-file ({e!r}) — truncated "
            "or corrupted write") from e


def _open_shards(path: str, m: dict, mmap: bool) -> list[np.ndarray]:
    """Open and validate every base shard the manifest names, viewed in the
    storage dtype (bf16 as uint16 bits). Missing, unreadable, truncated or
    misshapen shards raise :class:`CorruptArtifactError`."""
    sh = m["shards"]
    np_dtype, _ = STORE_DTYPES[sh.get("dtype", "f32")]
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    if len(sh["files"]) != len(sh["rows"]) or not sh["files"]:
        raise CorruptArtifactError(
            f"{path}: manifest shard table is malformed "
            f"({len(sh['files'])} files vs {len(sh['rows'])} row counts)")
    if sum(sh["rows"]) != m["n"]:
        raise CorruptArtifactError(
            f"{path}: manifest shard rows sum to {sum(sh['rows'])} but "
            f"n={m['n']} — truncated or corrupted artifact")
    shards = []
    for fname, rows in zip(sh["files"], sh["rows"]):
        p = os.path.join(dirname, fname)
        try:
            arr = np.load(p, mmap_mode="r" if mmap else None, allow_pickle=False)
            if arr.dtype != np_dtype:
                arr = arr.view(np_dtype)  # the reference's bf16 loads as void16
        except FileNotFoundError as e:
            raise CorruptArtifactError(
                f"{path}: base shard {fname!r} is missing — the shard set is "
                "incomplete (partial copy?)") from e
        except (ValueError, OSError, zipfile.BadZipFile, EOFError) as e:
            raise CorruptArtifactError(
                f"{path}: base shard {fname!r} is unreadable ({e}) — truncated "
                "or corrupted write") from e
        if arr.ndim != 2 or arr.shape != (rows, m["d"]):
            raise CorruptArtifactError(
                f"{path}: base shard {fname!r} shape {arr.shape} disagrees with "
                f"manifest ({rows}, {m['d']}) — truncated or corrupted artifact")
        shards.append(arr)
    return shards


def open_base_shards(path: str) -> tuple[list[np.ndarray], str]:
    """Memory-map a sharded artifact's base shards for the disk tier:
    (shard arrays, storage dtype name), ready for
    ``BaseStore.from_shards``. ValueError if the artifact is not sharded,
    :class:`CorruptArtifactError` if a shard is damaged."""
    path = normalize_path(path)
    blob = np.load(path, allow_pickle=False)
    if "manifest" not in blob.files:
        raise ValueError(f"{path}: legacy artifact has no shard table")
    m = json.loads(str(blob["manifest"][()]))
    if not m.get("shards"):
        raise ValueError(
            f"{path}: artifact is not sharded — the base lives in the npz; "
            "re-save with save_index(..., shard_rows=...) for the disk tier")
    return _open_shards(path, m, mmap=True), m["shards"].get("dtype", "f32")


def _decode_artifact(blob, path: str) -> IndexArtifact:
    if "manifest" not in blob.files:
        return _load_legacy(blob, path)
    m = json.loads(str(blob["manifest"][()]))
    if m.get("format") != FORMAT_MAGIC:
        raise CorruptArtifactError(
            f"{path}: manifest format {m.get('format')!r} != {FORMAT_MAGIC!r}")
    if m.get("version", 0) > ARTIFACT_VERSION:
        raise CorruptArtifactError(
            f"{path}: artifact schema v{m['version']} is newer than this build "
            f"supports (v{ARTIFACT_VERSION}) — upgrade, or rebuild the index "
            "with this version")
    if m.get("shards"):
        shards = _open_shards(path, m, mmap=False)
        base = np.concatenate([np.asarray(s) for s in shards])
        if m["shards"].get("dtype", "f32") == "bf16":
            base = bf16_to_f32(base)
    else:
        base = blob["base"]
    neighbors = blob["neighbors"]
    want = (m["n"], m["d"], m["degree"])
    got = (*base.shape, neighbors.shape[1])
    if want != got or neighbors.shape[0] != m["n"]:
        raise CorruptArtifactError(
            f"{path}: manifest shapes {want} disagree with arrays {got} — "
            "truncated or corrupted artifact")

    key = key_impl = None
    if m.get("key_impl") is not None:
        key = np.array(blob["key"], np.uint32)
        key_impl = m["key_impl"]

    hierarchy = None
    if m.get("num_layers", 0) > 0:
        L = m["num_layers"]
        hierarchy = HnswIndex(
            layers_neighbors=tuple(_cpu(blob[f"hier{i}_neighbors"], torch.int32)
                                   for i in range(L)),
            layers_nodes=tuple(_cpu(blob[f"hier{i}_nodes"], torch.int32) for i in range(L)),
            layers_slot=tuple(_cpu(blob[f"hier{i}_slot"], torch.int32) for i in range(L)),
            entry_point=_cpu(blob["hier_entry"], torch.int32).reshape(()),
            levels=_cpu(blob["hier_levels"], torch.int32),
        )

    pq = None
    if m.get("pq") is not None:
        rotation = None
        if m["pq"].get("rotation"):
            rotation = _cpu(blob["pq_rotation"], torch.float32)
        pq = PQIndex(codebooks=_cpu(blob["pq_codebooks"], torch.float32),
                     codes=_cpu(blob["pq_codes"], torch.uint8),
                     M=int(m["pq"]["m"]), K=int(m["pq"]["k"]), rotation=rotation)

    if m["version"] >= 2:
        hubs = _cpu(blob["hubs"], torch.int32)
        if hubs.shape[0] != m.get("n_hubs", hubs.shape[0]):
            raise CorruptArtifactError(
                f"{path}: manifest n_hubs={m.get('n_hubs')} disagrees with the "
                f"hubs array ({hubs.shape[0]}) — truncated or corrupted artifact")
        degree_stats = m.get("degree_stats", {})
    else:
        # v1 predates persisted hubs: recompute them from the adjacency
        hubs = hub_vertices(neighbors, DEFAULT_N_HUBS)
        degree_stats = {"out": degree_distribution(neighbors),
                        "in": in_degree_distribution(neighbors)}

    metadata = None
    if m.get("metadata"):
        metadata = {name: np.asarray(blob[f"meta_{name}"]) for name in m["metadata"]}
        for name, col in metadata.items():
            if col.shape != (m["n"],):
                raise CorruptArtifactError(
                    f"{path}: metadata column {name!r} shape {col.shape} disagrees "
                    f"with n={m['n']} — truncated or corrupted artifact")

    return IndexArtifact(
        base=_cpu(base, torch.float32), neighbors=_cpu(neighbors, torch.int32),
        metric=m["metric"], key=key, key_impl=key_impl, hierarchy=hierarchy, pq=pq,
        provenance=m.get("provenance", {}), version=m["version"], hubs=hubs,
        degree_stats=degree_stats, metadata=metadata,
    )


def exists(path: str) -> bool:
    return os.path.exists(normalize_path(path))
