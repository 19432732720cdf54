"""The persistent per-topology schedule-profile DB.

Counterpart of ``chainermn_tpu/tuning/profile_db.py``, with the same
file, the same environment variable and the same default path, so one DB
serves both packages. One JSON file maps a topology fingerprint
(:meth:`Topology.fingerprint`) to (a) tuned :class:`SchedulePlan` winners
keyed by model shape and (b) measured ``measure_strategies`` sweeps.
Consumed by ``AutoReducer(profile=...)`` and
``create_multi_node_optimizer(tune=...)``; written by
``python -m chainermn_torch.tools.schedtune`` and
``measure_strategies(db=...)``.

File layout (version 1)::

    {"version": 1,
     "plans":    {"<fingerprint>": {"<model_key>": {<SchedulePlan>}}},
     "measured": {"<fingerprint>": {"<strategy>:<bytes>": <us>}}}

A plan tuned for another fingerprint is refused by
``create_multi_node_optimizer(tune=...)``: a plan tuned for one machine
silently mis-tunes another.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from chainermn_torch.tuning.topology import Topology

#: env override for the default DB location (the JAX package's name)
PROFILE_DB_ENV = "CHAINERMN_TPU_PROFILE_DB"
_DEFAULT_PATH = os.path.join("~", ".cache", "chainermn_tpu",
                             "schedtune.json")


def default_db_path() -> str:
    return os.path.expanduser(
        os.environ.get(PROFILE_DB_ENV) or _DEFAULT_PATH)


def _flax_rows(tree, path=""):
    """``(keystr, shape, dtype name, elements, itemsize)`` of a nested
    mapping's leaves in ``jax.tree_util``'s order (keys sorted), with
    its ``keystr`` spelling of the path."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flax_rows(tree[k], f"{path}[{k!r}]")
        return
    shape = tuple(int(s) for s in getattr(tree, "shape", ()))
    dt = getattr(tree, "dtype", None)
    name = str(dt).replace("torch.", "") if dt is not None else "float32"
    item = getattr(tree, "itemsize", None) or (
        tree.element_size() if hasattr(tree, "element_size") else 4)
    n = 1
    for s in shape:
        n *= s
    yield path, shape, name, n, int(item)


def model_key_for(tree) -> str:
    """Deterministic model-shape key: leaf count, total payload bytes, and
    a digest of the (path, shape, dtype) list.

    ``tree`` is a module or a (nested) dict of tensors or arrays. A
    module the converters map (the MLP, the TransformerLM, the ViT:
    ``models.convert.flax_param_order``) is keyed over its parameters in
    flax's layout and paths (``models.convert.flax_params``), so its key
    equals the JAX package's ``model_key_for`` of the converted
    parameters, and a plan tuned by either package is found by the
    other. Any other module is keyed over its ``named_parameters`` in
    torch's layout, which no JAX tree shares. A dict is keyed as JAX keys
    the same dict."""
    import torch

    if isinstance(tree, torch.nn.Module):
        from chainermn_torch.models.convert import flax_params
        from chainermn_torch.models.mlp import MLP
        from chainermn_torch.models.transformer import TransformerLM
        from chainermn_torch.models.vit import ViT

        if isinstance(tree, (MLP, TransformerLM, ViT)):
            tree = flax_params(tree)
        else:
            tree = dict(tree.named_parameters())
    rows, total = [], 0
    for path, shape, dt, n, item in _flax_rows(tree):
        total += n * item
        rows.append(f"{path}:{shape}:{dt}")
    digest = hashlib.sha1("\n".join(rows).encode()).hexdigest()[:8]
    return f"{len(rows)}l-{total}B-{digest}"


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """One tuned collective schedule: the reducer knobs plus the evidence
    that chose them. ``buckets`` is the per-bucket ``(algorithm,
    payload_bytes)`` assignment (informational: the reducer re-plans
    from ``bucket_bytes``/``bucket_order`` at run time)."""

    fingerprint: str
    model_key: str
    strategy: str
    bucket_bytes: int
    bucket_order: str = "emission"
    double_buffering: bool = False
    #: what the quantized wire carries ('f32' = uncompressed)
    wire_format: str = "f32"
    overlap_fraction: float = 0.0
    est_exposed_us: float = 0.0
    #: 'canned' (emulated schedule), 'aot' (JAX's compiled HLO), 'trace'
    #: (the port's measured device trace) or 'measured'
    source: str = "canned"
    buckets: Tuple[Tuple[str, int], ...] = ()
    #: for strategy 'synth': the winning Program's to_dict() form
    program: Optional[dict] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["buckets"] = [list(b) for b in self.buckets]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulePlan":
        d = dict(d)
        d["buckets"] = tuple(
            (str(a), int(n)) for a, n in d.get("buckets", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _fp(topology: Union[Topology, str]) -> str:
    return (topology if isinstance(topology, str)
            else topology.fingerprint())


class ProfileDB:
    """JSON-file profile store with atomic writes.

    ``path=None`` resolves ``$CHAINERMN_TPU_PROFILE_DB`` then the default
    ``~/.cache/chainermn_tpu/schedtune.json``. A missing or unreadable
    file is an empty DB, never an error: tuning must work on a fresh
    machine.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else default_db_path()
        self._data: Dict[str, Any] = {
            "version": 1, "plans": {}, "measured": {}}
        try:
            with open(self.path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and loaded.get("version") == 1:
                self._data.update(loaded)
        except (OSError, ValueError):
            pass

    # -- plans ----------------------------------------------------------
    def put_plan(self, plan: SchedulePlan) -> None:
        self._data["plans"].setdefault(
            plan.fingerprint, {})[plan.model_key] = plan.to_dict()

    def plan_for(self, topology: Union[Topology, str],
                 model_key: Optional[str] = None
                 ) -> Optional[SchedulePlan]:
        """The stored plan for this topology (and model shape).
        ``model_key=None`` accepts a sole stored plan or one stored under
        ``'default'``; ambiguity returns ``None`` rather than guessing."""
        entries = self._data["plans"].get(_fp(topology), {})
        if model_key is not None:
            d = entries.get(model_key)
        elif len(entries) == 1:
            d = next(iter(entries.values()))
        else:
            d = entries.get("default")
        return SchedulePlan.from_dict(d) if d else None

    # -- measured sweeps ------------------------------------------------
    def put_measured(self, topology: Union[Topology, str],
                     table: Dict[Tuple[str, int], float]) -> None:
        dst = self._data["measured"].setdefault(_fp(topology), {})
        for (strategy, nbytes), us in table.items():
            dst[f"{strategy}:{int(nbytes)}"] = float(us)

    def measured_for(self, topology: Union[Topology, str]
                     ) -> Dict[Tuple[str, int], float]:
        out: Dict[Tuple[str, int], float] = {}
        for key, us in self._data["measured"].get(_fp(topology),
                                                  {}).items():
            strategy, _, nbytes = key.rpartition(":")
            out[(strategy, int(nbytes))] = float(us)
        return out

    # -- persistence ----------------------------------------------------
    def save(self) -> str:
        """Atomic write (a temporary file, then a rename); returns the
        path."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".schedtune-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path


def open_db(db) -> ProfileDB:
    """A :class:`ProfileDB` from ``db``: a DB (returned as is), a path,
    or anything else (``True``) for the default location."""
    if isinstance(db, ProfileDB):
        return db
    return ProfileDB(db if isinstance(db, str) else None)
