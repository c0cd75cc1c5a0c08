"""Content-keyed deployment pool: long-lived Sessions per served graph.

Port of ``repro.serving.pool``.  A *deployment* is a sparse graph plus
its stationary dense operands (factor matrices, projected embeddings)
made ready to serve: a ``DistProblem`` wrapped in an ``ElasticProblem``
(so serving rounds survive ``DeviceLost`` mid-stream), a dedicated
``api.Session`` whose replication cache serves the stationary
operands' fiber gathers to every tick, and the operands themselves,
uploaded to the grid's device once, at deploy time.  A tick then moves
only coordinates: the Session's identity memo keys a deployed operand
by the tensor's version counter, so no tick sums or uploads it.

The pool is keyed by CONTENT (:func:`content_key`: structure, values,
shape, width, family and wire choice, every named operand), so
re-deploying the same graph with refreshed factors is a miss while an
identical re-deploy is a hit.  The key is paid once a deploy.  Eviction
is LRU over deployments, bounded by ``capacity``; a deployment pinned
by an in-flight tick is never evicted (the pool overshoots capacity and
evicts at the next opportunity).  An evicted deployment holds no
reference cycle, so its device memory is freed as it leaves the pool.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.serving.requests import hash_array

__all__ = ["Deployment", "SessionPool", "content_key"]


def _float32(a):
    return a.float() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def content_key(rows, cols, vals, shape, r, *, algorithm="auto",
                comm="dense", operands=None) -> str:
    """The pool's deployment digest: the reference's bytes (rows and
    cols in their own dtype, float32 values, each operand's name, shape
    and float32 bytes, in name order) under blake2b-128, so one
    deployment has one key in both packages."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{shape[0]}x{shape[1]}:r{r}:{algorithm}:{comm}".encode())
    hash_array(h, rows)
    hash_array(h, cols)
    hash_array(h, _float32(vals))
    for name in sorted(operands or {}):
        a = _float32(operands[name])
        h.update(name.encode())
        h.update(str(tuple(a.shape)).encode())
        hash_array(h, a)
    return h.hexdigest()


def _on(dev, a) -> torch.Tensor:
    """A float32 copy of ``a`` on ``dev`` that the deployment owns."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=dev, dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


@dataclasses.dataclass
class Deployment:
    """One served graph: elastic problem + Session + stationary operands
    (float32 tensors on the grid's device)."""
    key: str
    elastic: api.ElasticProblem
    session: api.Session
    operands: Dict[str, torch.Tensor]
    pins: int = 0
    #: under a process group, the :class:`api.RankRetired` that took this
    #: process out of the deployment's degraded grid (None while it holds
    #: a rank): the engine runs none of the deployment's rounds here
    retired: Optional[api.RankRetired] = None
    #: zero-padded copies of the deployed operands, by (key, width,
    #: device): ticks hand the Session the same tensor, which its
    #: identity memo recognises without hashing
    _pad_cache: dict = dataclasses.field(default_factory=dict)
    #: union-pattern problems of recent ticks, by (pattern digest, width),
    #: each with the problem it was derived from: valid only while that
    #: is the elastic facade's current problem (bounded LRU)
    _pattern_cache: "collections.OrderedDict" = dataclasses.field(
        default_factory=collections.OrderedDict)
    pattern_cache_max: int = 8

    @property
    def problem(self) -> api.DistProblem:
        """The CURRENT problem: after a mid-stream DeviceLost, the one
        the elastic facade re-planned onto the degraded grid."""
        return self.elastic.problem

    def operand(self, name: str) -> torch.Tensor:
        return self.operands[name]

    def padded(self, arr, width: int, key: Optional[str] = None):
        """``arr`` as float32 on the problem's device, zero-padded to
        ``width`` columns.  An operand already there at that width is
        returned as it is.  The padded copy of a deployed operand (``key``
        ``"operand:<name>"``) is cached; any other is padded anew each
        round, so a client's operand holds no device memory after its
        request."""
        dev = self.problem.grid.device
        t = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.asarray(arr, np.float32))
        t = t.to(device=dev, dtype=torch.float32)
        if t.shape[1] == width:
            return t
        if t.shape[1] > width:
            raise ValueError(f"cannot pad width {t.shape[1]} down "
                             f"to {width}")
        ck = (key, width, dev)
        out = self._pad_cache.get(ck)
        if out is None:
            out = torch.zeros((t.shape[0], width), dtype=torch.float32,
                              device=dev)
            out[:, :t.shape[1]] = t
            if key is not None and key.startswith("operand:"):
                self._pad_cache[ck] = out
        return out

    def pattern_problem(self, u_rows, u_cols, width: int,
                        pattern_key: str) -> api.DistProblem:
        """The union-pattern problem at ``width``, LRU-cached while the
        deployment's problem is unchanged (after a re-plan the entry's
        base is no longer the facade's problem, and it is rebuilt on the
        degraded grid)."""
        base = self.problem
        ck = (pattern_key, width)
        hit = self._pattern_cache.get(ck)
        if hit is not None and hit[0] is base:
            self._pattern_cache.move_to_end(ck)
            return hit[1]
        qp = base.with_pattern(u_rows, u_cols).with_r(width)
        self._pattern_cache[ck] = (base, qp)
        self._pattern_cache.move_to_end(ck)
        while len(self._pattern_cache) > self.pattern_cache_max:
            self._pattern_cache.popitem(last=False)
        return qp


class SessionPool:
    """LRU pool of live deployments, keyed by content digest.

    ``deploy`` is idempotent on content: a digest already resident is a
    hit (the live deployment, Session intact); a new digest plans the
    problem (lazily: packs are built by the first round that needs
    them), uploads the operands, builds its Session and, once over
    ``capacity``, evicts the least-recently-used UNPINNED deployment.
    ``stats()`` reports hit/miss/eviction counts, occupancy and the
    Session stats summed over resident deployments.
    """

    def __init__(self, capacity: int = 4, session_entries: int = 32,
                 policy: Optional[api.RetryPolicy] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.session_entries = session_entries
        self.policy = policy
        self._deployments: "collections.OrderedDict[str, Deployment]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._deployments)

    def __contains__(self, key: str) -> bool:
        return key in self._deployments

    @property
    def keys(self):
        """Resident digests, least- to most-recently-used."""
        return list(self._deployments)

    def get(self, key: str) -> Optional[Deployment]:
        dep = self._deployments.get(key)
        if dep is not None:
            self._deployments.move_to_end(key)
        return dep

    def resident(self, key: str) -> Optional[Deployment]:
        """The resident deployment of ``key``, if any, leaving the LRU
        order as it is (a serving rank resolving a tick record)."""
        return self._deployments.get(key)

    def deploy(self, rows, cols, vals, shape, r, *, operands=None,
               algorithm: str = "auto", c: Optional[int] = None,
               devices=None, group=None, comm: str = "dense",
               row_tile: int = 32, nz_block: int = 32) -> Deployment:
        """Deploy (or find) a graph.  ``devices`` and ``group`` as for
        ``api.make_problem`` (default: one card); the key does not name
        them, as the reference's does not.

        Under a process group this is a collective: every process makes
        the same call (each hashes its own copy of the content, all at
        once) and the keys are compared across the group, which raises
        on every process if any differs.  The pool's hits, misses and
        evictions then follow one sequence on every process."""
        key = content_key(rows, cols, vals, shape, r,
                          algorithm=algorithm, comm=comm,
                          operands=operands)
        if group is not None:
            import torch.distributed as dist
            keys = [None] * dist.get_world_size(group)
            dist.all_gather_object(keys, key, group=group)
            if len(set(keys)) != 1:
                raise ValueError(f"deploy under a process group: the ranks' "
                                 f"content keys differ: {keys}")
        dep = self._deployments.get(key)
        if dep is not None:
            self.hits += 1
            self._deployments.move_to_end(key)
            return dep
        self.misses += 1
        prob = api.make_problem(rows, cols, vals, shape, r,
                                algorithm=algorithm, c=c, devices=devices,
                                group=group, comm=comm, row_tile=row_tile,
                                nz_block=nz_block)
        session = api.Session(max_entries=self.session_entries)
        dev = prob.grid.device
        dep = Deployment(
            key,
            api.ElasticProblem(prob, session=session, policy=self.policy),
            session,
            {k: _on(dev, v) for k, v in (operands or {}).items()})
        self._deployments[key] = dep
        self._evict_over_capacity()
        return dep

    def _evict_over_capacity(self):
        # LRU order, skipping pinned deployments: in-flight ticks hold a
        # pin, so eviction never pulls a Session out from under a round;
        # if everything is pinned the pool overshoots and retries later
        while len(self._deployments) > self.capacity:
            victim = next((k for k, d in self._deployments.items()
                           if d.pins == 0), None)
            if victim is None:
                return
            del self._deployments[victim]
            self.evictions += 1

    @contextlib.contextmanager
    def pin(self, *deployments: Deployment):
        """Hold the given deployments un-evictable for a tick's scope."""
        for d in deployments:
            d.pins += 1
        try:
            yield
        finally:
            for d in deployments:
                d.pins -= 1
            self._evict_over_capacity()

    def stats(self) -> dict:
        sess = dict(hits=0, misses=0, entries=0)
        for d in self._deployments.values():
            s = d.session.stats()
            sess["hits"] += s["hits"]
            sess["misses"] += s["misses"]
            sess["entries"] += s["entries"]
        total = self.hits + self.misses
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions,
                    occupancy=len(self._deployments),
                    capacity=self.capacity,
                    pinned=sum(1 for d in self._deployments.values()
                               if d.pins),
                    hit_rate=(self.hits / total) if total else 0.0,
                    session=sess)
