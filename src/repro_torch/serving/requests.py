"""Request, ticket and admission-queue layer of the serving engine.

Port of ``repro.serving.requests``.  The engine speaks two request
shapes, the two kernel shapes inference traffic over a deployed sparse
graph takes (paper §VII):

* :class:`ScoreRequest` -- "score these (i, j) pairs": an SDDMM sampled
  at the request's coordinates, ``<X_i, Y_j>`` per pair (CF prediction,
  GAT edge scores);
* :class:`AggregateRequest` -- "push this dense block through the
  graph": an SpMM right-hand side against the deployment's values,
  optionally overridden per request (embedding lookups, neighbourhood
  aggregation).

Operands are numpy arrays or float32 tensors; a deployment's operands
are tensors already on its grid's device, so a request naming one
moves no operand.  Both requests carry keys of their dense operands so
the batcher groups mergeable work without comparing arrays: a numpy
operand's is its content digest (:func:`digest`), as the reference's; a
tensor's is its identity, since hashing it would copy it to the host
every request, and a request holds its tensors alive, so no other
tensor takes its identity while the key is in use.

:class:`RequestQueue` is the admission policy: a bounded FIFO that
fails fast (:class:`AdmissionError`) once ``max_pending`` requests
wait; the rejections are counted in its stats.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
from typing import List, Optional

import numpy as np
import torch

__all__ = ["AdmissionError", "AggregateRequest", "RequestQueue",
           "ScoreRequest", "Ticket", "WireRequest", "digest", "from_wire",
           "hash_array", "to_wire"]

#: elements of a device tensor copied to the host at a time for hashing
_HASH_CHUNK = 1 << 26


class AdmissionError(RuntimeError):
    """The queue is full: the request was rejected at admission."""


def hash_array(h, a) -> None:
    """Feed ``a``'s bytes in C order to the hash ``h``: a numpy array as
    it is, a tensor copied to the host a chunk at a time (so hashing a
    large operand holds no second host copy of it)."""
    if isinstance(a, torch.Tensor):
        flat = a.detach().contiguous().reshape(-1)
        for chunk in flat.split(_HASH_CHUNK):
            h.update(chunk.cpu().numpy())
    else:
        h.update(np.ascontiguousarray(a))


def digest(arr) -> str:
    """Content digest of an array: shape, dtype and bytes under
    blake2b-128, the reference's for the same numpy array (a tensor
    digests as its numpy copy would)."""
    if isinstance(arr, torch.Tensor):
        shape = tuple(arr.shape)
        dtype = str(arr.dtype).replace("torch.", "")
    else:
        arr = np.asarray(arr)
        shape, dtype = arr.shape, str(arr.dtype)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(shape).encode())
    h.update(dtype.encode())
    hash_array(h, arr)
    return h.hexdigest()


def _operand(a):
    """A dense operand: a tensor stays where it is (float32), anything
    else becomes a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a if a.dtype == torch.float32 else a.float()
    return np.asarray(a, np.float32)


def _key(a) -> str:
    """A dense operand's grouping key: a tensor's identity, a numpy
    array's content digest."""
    return f"tensor:{id(a)}" if isinstance(a, torch.Tensor) else digest(a)


def _coords(a) -> np.ndarray:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.reshape(-1)


@dataclasses.dataclass
class ScoreRequest:
    """SDDMM samples ``<X_i, Y_j>`` at the request's (rows, cols) pairs.

    ``X (m, w)`` / ``Y (n, w)`` are operands on the deployment's shape;
    ``w`` is the query width (padded to the family's feasible width in
    the round; zero columns add nothing to a dot).  ``x_key`` /
    ``y_key`` group requests: those sharing ``y_key`` and width can
    coalesce into one union-of-patterns SDDMM (the X-side rule is in
    :mod:`repro_torch.serving.batcher`).
    """
    deployment: object
    rows: np.ndarray
    cols: np.ndarray
    X: object
    Y: object
    x_key: str
    y_key: str
    kind = "score"

    @classmethod
    def make(cls, deployment, rows, cols, X, Y,
             x_key: Optional[str] = None,
             y_key: Optional[str] = None) -> "ScoreRequest":
        prob = deployment.problem
        rows, cols = _coords(rows), _coords(cols)
        if rows.shape != cols.shape or len(rows) == 0:
            raise ValueError("score query needs matching non-empty "
                             "rows/cols")
        X, Y = _operand(X), _operand(Y)
        if X.ndim != 2 or X.shape[0] != prob.m:
            raise ValueError(f"X must be (m={prob.m}, w), got "
                             f"{tuple(X.shape)}")
        if Y.ndim != 2 or tuple(Y.shape) != (prob.n, X.shape[1]):
            raise ValueError(f"Y must be (n={prob.n}, w={X.shape[1]}), "
                             f"got {tuple(Y.shape)}")
        if (int(rows.min()) < 0 or int(rows.max()) >= prob.m
                or int(cols.min()) < 0 or int(cols.max()) >= prob.n):
            raise ValueError("query coordinates outside the deployment "
                             f"shape ({prob.m}, {prob.n})")
        return cls(deployment, rows, cols, X, Y,
                   x_key=x_key if x_key is not None else _key(X),
                   y_key=y_key if y_key is not None else _key(Y))

    @property
    def width(self) -> int:
        return int(self.X.shape[1])


@dataclasses.dataclass
class AggregateRequest:
    """SpMM right-hand side ``Y (n, w)`` against the deployment's values.

    ``vals=None`` uses the deployed values (every such request in a tick
    rides one batched-RHS SpMM); a per-request ``vals`` override (the
    deployment's host COO order, e.g. a client's softmaxed attention)
    groups only with requests carrying the same override: the same
    content for numpy, the same tensor for a tensor (hashing a device
    tensor would copy it to the host every request; the key only groups
    one tick's requests, which hold their tensors alive).
    """
    deployment: object
    Y: object
    vals: object
    vals_key: str
    kind = "aggregate"

    @classmethod
    def make(cls, deployment, Y, vals=None) -> "AggregateRequest":
        prob = deployment.problem
        Y = _operand(Y)
        if Y.ndim != 2 or Y.shape[0] != prob.n:
            raise ValueError(f"Y must be (n={prob.n}, w), got "
                             f"{tuple(Y.shape)}")
        if vals is None:
            key = "deployed"
        else:
            vals = _operand(vals)
            if tuple(vals.shape) != (prob.nnz,):
                raise ValueError(f"vals override must be ({prob.nnz},) "
                                 "in host COO order, got "
                                 f"{tuple(vals.shape)}")
            key = _key(vals)
        return cls(deployment, Y, vals, vals_key=key)

    @property
    def width(self) -> int:
        return int(self.Y.shape[1])


@dataclasses.dataclass
class WireRequest:
    """A request as it travels in a tick record, from the front end of a
    process group to the other ranks (:mod:`repro_torch.serving.server`).

    It names its deployment by content key and carries the front end's
    grouping keys, so a rank that rebuilds it (:func:`from_wire`) groups
    it as the front end does: a tensor's key is its identity on the
    front end, which means nothing in another process.  Each dense
    operand is ``("operand", name)``, a deployment operand that every
    rank holds already, or ``("tensor", i)``, the tick's i-th sent
    tensor; ``operands`` are (X, Y) for a score request and (Y, vals)
    for an aggregate one (vals None: the deployed values)."""
    kind: str
    deployment: str
    rows: Optional[np.ndarray]
    cols: Optional[np.ndarray]
    operands: tuple
    keys: tuple
    width: int


def _operand_ref(deployment, a, sent: list):
    """How operand ``a`` travels: by name if it is one of the
    deployment's operands, else as the index of its tensor in ``sent``
    (each distinct object sent once a tick)."""
    if a is None:
        return None
    for name, t in deployment.operands.items():
        if t is a:
            return ("operand", name)
    for i, b in enumerate(sent):
        if b is a:
            return ("tensor", i)
    sent.append(a)
    return ("tensor", len(sent) - 1)


def to_wire(request, sent: list) -> WireRequest:
    """``request``'s wire form; the operands that must travel are
    appended to ``sent`` (numpy arrays or tensors, as submitted)."""
    dep = request.deployment
    if request.kind == "score":
        return WireRequest("score", dep.key, request.rows, request.cols,
                           (_operand_ref(dep, request.X, sent),
                            _operand_ref(dep, request.Y, sent)),
                           (request.x_key, request.y_key), request.width)
    return WireRequest("aggregate", dep.key, None, None,
                       (_operand_ref(dep, request.Y, sent),
                        _operand_ref(dep, request.vals, sent)),
                       (request.vals_key,), request.width)


def from_wire(w: WireRequest, deployment, tensors):
    """The request ``w`` names, on this rank's ``deployment`` with the
    tick's received ``tensors``: equal to the front end's, keys and all
    (the front end validated it when it was submitted)."""
    def operand(ref):
        if ref is None:
            return None
        kind, v = ref
        return deployment.operand(v) if kind == "operand" else tensors[v]

    a, b = (operand(ref) for ref in w.operands)
    if w.kind == "score":
        return ScoreRequest(deployment, w.rows, w.cols, a, b, *w.keys)
    return AggregateRequest(deployment, a, b, *w.keys)


@dataclasses.dataclass
class Ticket:
    """The caller's handle on a submitted request (a synchronous future).

    ``arrival`` / ``completion`` are trace timestamps in the caller's
    clock (the replay's simulated seconds);
    :func:`repro_torch.serving.server.replay_trace` stamps completion as
    tick start + the tick's measured wall time.  A result is a tensor on
    the deployment's device: a score request's (k,) samples, an
    aggregate request's (m, w) rows.
    """
    request: object
    seq: int
    arrival: float = 0.0
    completion: Optional[float] = None
    done: bool = False
    batched_with: int = 0
    _result: object = None
    _error: Optional[BaseException] = None

    def fulfill(self, result):
        self._result = result
        self.done = True

    def fail(self, error: BaseException):
        self._error = error
        self.done = True

    def result(self):
        if not self.done:
            raise RuntimeError(f"ticket {self.seq} still pending -- "
                               "run engine.tick() first")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency(self) -> Optional[float]:
        if self.completion is None:
            return None
        return self.completion - self.arrival


class RequestQueue:
    """Bounded FIFO with fail-fast admission: a request is accepted iff
    fewer than ``max_pending`` tickets wait, else :class:`AdmissionError`;
    ``rejected`` counts shed requests."""

    def __init__(self, max_pending: int = 256):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_pending = max_pending
        self._pending: collections.deque = collections.deque()
        self._seq = itertools.count()
        self.admitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, request, arrival: float = 0.0) -> Ticket:
        if len(self._pending) >= self.max_pending:
            self.rejected += 1
            raise AdmissionError(
                f"queue full ({self.max_pending} pending); request "
                "rejected at admission")
        t = Ticket(request, next(self._seq), arrival=arrival)
        self._pending.append(t)
        self.admitted += 1
        return t

    def drain(self, max_requests: Optional[int] = None) -> List[Ticket]:
        """Pop up to ``max_requests`` tickets in FIFO order (one tick's
        worth of work)."""
        k = len(self._pending) if max_requests is None else \
            min(max_requests, len(self._pending))
        return [self._pending.popleft() for _ in range(k)]

    def stats(self) -> dict:
        return dict(pending=len(self._pending), admitted=self.admitted,
                    rejected=self.rejected,
                    max_pending=self.max_pending)
