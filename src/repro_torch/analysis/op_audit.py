"""Op-level determinism auditor (counterpart of ``repro/analysis/jaxpr_audit.py``).

The reference traces each captured stage to a ClosedJaxpr.  A torch stage
has no program to read, so the port reruns it: ``record_stage`` runs
``cap.fn(*cap.args)`` — the exact function and operands ``engine/plan.py``
reported through its stage observer — outside any CUDA graph capture, under
a recording ``TorchDispatchMode``.  Every aten op of the run is recorded
with the shapes, dtypes and devices of its inputs and outputs, and each
tensor input is marked by whether its storage descends from the stage's
arguments: by storage identity, through views, ``.to`` copies and the
outputs of earlier recorded ops.  The checks read that record:

* ``const-array``   — an op input whose storage is neither an argument nor
                      derived from one (INV-ARGS-NOT-CONSTS): a CUDA graph
                      reads that address for ever.  The exemption policy is
                      the reference's (``_classify_const``): scalars / tiny
                      tensors, uniform fills, integer iotas and small integer
                      tables, seeded ±1/0 factors (RHDH signs and Hadamard
                      blocks) and ≤16-entry float tables (the Lloyd-Max
                      codebooks) — every per-device cache of the kernels.
* ``full-scan-dot`` — a float ``mm`` / ``addmm`` / ``mv`` (``matmul`` and
                      ``linear`` reach aten as these) with a free dim ≥
                      ``n_corpus`` and a query side other than the fixed
                      8-row chunk of ``kernels/ref.py``: on the card every
                      corpus-scale product is a hand-written kernel, so such
                      an op there is a cuBLAS product whose last bit moves
                      with the batch shape.  The corpus is the right-hand
                      operand, as in the reference.  A ``bmm`` / ``baddbmm``
                      is exempt, as the reference exempts batched and
                      rank > 2 contractions: per-query candidate scoring
                      (tiling-stable by the gathered-scan contract), or a
                      rank-2 x rank-3 einsum folded to a unit batch (the
                      plain Kronecker Hadamard's ±1 blocks).
* ``full-reduce``   — a float sum / mean / prod / cumsum / norm over ≥
                      ``n_corpus`` elements outside that chunk.
* ``x64-leak``      — a float64 / complex128 tensor (int64 is torch's index
                      dtype and the port's key planes: exempt).
* ``callback-prim`` — a host round trip: ``_local_scalar_dense`` (``.item()``,
                      ``int()``, ``bool()`` of a tensor) or a copy from a CUDA
                      tensor to the host.
* ``rng-prim``      — any aten random op.

A stage that raises when rerun is a ``stage-failure``.  The hand-written
kernels are ctypes launches, not aten ops: ``record_stage`` reads their
launch counters (``cuda_build.count_launch``) around the run and records
which of B1-B7 the stage launched.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding
from .invariants import annotate

#: The pinned query-chunk granularity of every full-scan dot
#: (kernels/ref.py _ROW_CHUNK, the reference's block_q grain).
ROW_CHUNK = 8

#: Size above which an integer/bool constant counts as corpus-scale.
INT_CONST_LIMIT = 1024
#: Size above which a non-exempt float constant is a hazard.  16 admits the
#: 4-bit Lloyd-Max codebook; anything larger must be ±1/0 (RHDH factors).
FLOAT_CONST_LIMIT = 16

#: The hand-written kernels: (id, kernels module, wrapper), ROADMAP B1-B7.
KERNELS = (
    ("B1", "nibble_dot", "nibble_dot_cuda"),
    ("B2", "hadamard", "fwht_cuda"),
    ("B3", "nibble_dot", "crumb_dot_cuda"),
    ("B4", "gather_dot", "gather_nibble_dot_cuda"),
    ("B5", "gather_dot", "gather_crumb_dot_cuda"),
    ("B6", "binary_dot", "sign_hamming_cuda"),
    ("B7", "binary_dot", "crumb_affinity_cuda"),
)

_RNG_OPS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "normal_", "uniform", "uniform_", "bernoulli",
    "bernoulli_", "multinomial", "random_", "exponential_", "cauchy_",
    "log_normal_", "geometric_", "poisson", "native_dropout",
})
_DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv"})
_REDUCE_OPS = frozenset({"sum", "nansum", "mean", "prod", "cumsum", "cumprod",
                         "norm", "linalg_vector_norm", "var", "std", "logsumexp"})
_COPY_OPS = frozenset({"_to_copy", "copy_", "copy", "_copy_from"})
_X64_DTYPES = frozenset({"float64", "complex128"})

CHECKS = (
    "const-array", "full-scan-dot", "full-reduce", "x64-leak",
    "callback-prim", "rng-prim",
)


@dataclasses.dataclass
class StageCapture:
    """One stage invocation captured from the engine's observer hook."""

    backend: str                  # plan backend kind (or "SelfTest")
    stage: str                    # plan stage name ("rotate", "scan", ...)
    fn: Callable[..., Any]        # the stage callable, run eagerly
    args: Tuple[Any, ...]         # the concrete operands it was called with
    context: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # context keys used by checks:
    #   n_corpus  — smallest per-segment row count of the grid index; any
    #               rank-2 float dot with a free dim >= n_corpus is treated
    #               as a full-corpus scan.
    #   label     — human grid-point label for reports.
    # set by audit_captures:
    #   launches  — {kernel id: launches} of the rerun (B1-B7 that ran).

    @property
    def site(self) -> str:
        return f"{self.backend}/{self.stage}"


@dataclasses.dataclass(frozen=True)
class TensorUse:
    shape: Tuple[int, ...]
    dtype: str                    # "float32", "int64", ... (numpy's names)
    device: str
    derived: bool                 # an argument's storage, or an op's output


@dataclasses.dataclass
class OpRecord:
    name: str                     # the aten overload, "aten.mm.default"
    op: str                       # its packet, "mm"
    inputs: List[TensorUse]
    outputs: List[TensorUse]
    params: Dict[str, Any]        # the op's non-tensor arguments by name


@dataclasses.dataclass
class StageRecord:
    ops: List[OpRecord]
    consts: List[torch.Tensor]    # inputs of no argument's lineage, one per storage
    launches: Dict[str, int]      # kernel id -> launches during the run


# ---------------------------------------------------------------------------
# Recording.
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def rec(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for item in x:
                rec(item)
        elif isinstance(x, dict):
            for item in x.values():
                rec(item)
    rec(tree)
    return out


def _storage_key(t: torch.Tensor) -> Optional[tuple]:
    """The identity of ``t``'s storage, or None for an empty tensor."""
    if t.numel() == 0:
        return None
    try:
        ptr = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    return (t.device.type, t.device.index, ptr)


def _named_params(func: Any, args: tuple, kwargs: dict) -> Dict[str, Any]:
    names = [a.name for a in func._schema.arguments]
    params = dict(zip(names, args))
    params.update(kwargs)
    return {k: v for k, v in params.items() if not _tensors(v)}


def _use(t: torch.Tensor, derived: bool) -> TensorUse:
    return TensorUse(tuple(int(d) for d in t.shape), _dtype_name(t.dtype),
                     str(t.device), derived)


class _Recorder(TorchDispatchMode):
    """Records every aten op and the lineage of its tensor inputs."""

    def __init__(self, roots: Sequence[torch.Tensor]) -> None:
        super().__init__()
        self.derived = {k for k in map(_storage_key, roots) if k is not None}
        self.ops: List[OpRecord] = []
        self.consts: Dict[tuple, torch.Tensor] = {}
        self._held: List[Any] = []    # outputs stay alive: no address is reused

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        uses = []
        for t in _tensors((args, kwargs)):
            key = _storage_key(t)
            derived = key is None or key in self.derived
            if not derived:
                self.consts.setdefault(key, t)
            uses.append(_use(t, derived))
        outs = _tensors(out)
        for t in outs:
            key = _storage_key(t)
            if key is not None:
                self.derived.add(key)
        self._held.append(out)
        self.ops.append(OpRecord(name=str(func), op=func.overloadpacket.__name__,
                                 inputs=uses, outputs=[_use(t, True) for t in outs],
                                 params=_named_params(func, args, kwargs)))
        return out


def kernel_counts() -> Dict[str, int]:
    """Each hand-written kernel's launch counter, by kernel id."""
    counts = {}
    for kid, module, wrapper in KERNELS:
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        counts[kid] = int(getattr(mod, wrapper).launches)
    return counts


def record_stage(cap: StageCapture) -> StageRecord:
    """Rerun ``cap.fn(*cap.args)`` eagerly under the recorder (the caller
    makes sure no stream is capturing) and return its op record."""
    before = kernel_counts()
    recorder = _Recorder(_tensors(cap.args))
    with recorder:
        cap.fn(*cap.args)
    after = kernel_counts()
    return StageRecord(ops=recorder.ops, consts=list(recorder.consts.values()),
                       launches={k: after[k] - before[k] for k in after
                                 if after[k] != before[k]})


# ---------------------------------------------------------------------------
# Checks.
# ---------------------------------------------------------------------------

def _classify_const(value: Any) -> Optional[str]:
    """None = exempt; otherwise a stable hazard class string (the
    reference's policy, verbatim)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.ndim == 0 or arr.size <= 8:
        return None                                   # scalar / tiny
    flat = arr.reshape(-1)
    first = flat[0]
    if bool(np.all(flat == first)):
        return None                                   # uniform fill
    if arr.dtype.kind in "iub":
        if arr.ndim == 1 and bool(np.all(np.diff(flat.astype(np.int64)) == 1)):
            return None                               # iota / arange
        if arr.size <= INT_CONST_LIMIT:
            return None
        return f"int-array[{arr.dtype}]"
    if arr.dtype.kind == "f":
        if bool(np.all(np.isin(flat, (-1.0, 0.0, 1.0)))):
            return None                               # seeded ±1/0 factor
        if arr.size <= FLOAT_CONST_LIMIT:
            return None                               # Lloyd-Max table
        return f"float-array[{arr.dtype}]"
    return f"array[{arr.dtype}]"


def _check_consts(record: StageRecord, cap: StageCapture) -> List[Finding]:
    found: List[Finding] = []
    for const in record.consts:
        if const.dtype == torch.bfloat16:
            const = const.float()
        cls = _classify_const(const)
        if cls is None:
            continue
        found.append(Finding(
            check="const-array",
            site=cap.site,
            detail=(
                f"stage reads a {cls} tensor (ndim={const.ndim}) that is "
                f"neither an argument nor derived from one: tensors must ride "
                f"as stage ARGUMENTS — a CUDA graph bakes a closure tensor's "
                f"address in"),
            signature=("const-array", cls, f"ndim={const.ndim}"),
        ))
    return found


def _dot_dims(rec: OpRecord) -> Optional[Tuple[int, int, int, int]]:
    """(lhs_free, rhs_free, n_batch, contraction) of a product op."""
    shapes = [u.shape for u in rec.inputs]
    if rec.op in ("addmm", "baddbmm", "addmv"):
        shapes = shapes[1:]                           # the bias comes first
    if len(shapes) < 2:
        return None
    a, b = shapes[0], shapes[1]
    if len(a) == 2 and len(b) == 1:                   # mv
        return 1, a[0], 0, a[1]
    if len(a) == 2 and len(b) == 2:
        return a[0], b[1], 0, a[1]
    if len(a) == 3 and len(b) == 3:
        return a[1], b[2], 1, a[2]
    return None


def _reduced_elements(rec: OpRecord) -> int:
    shape = rec.inputs[0].shape
    dims = rec.params.get("dim")
    if dims is None or dims == [] or dims == ():
        return int(np.prod(shape or (1,)))
    dims = [dims] if isinstance(dims, int) else list(dims)
    return int(np.prod([shape[d] for d in dims] or [1]))


def _reduce_chunk_safe(rec: OpRecord) -> bool:
    """The reduction runs inside an 8-row query chunk: its input's leading
    dim is the chunk and is not reduced."""
    shape = rec.inputs[0].shape
    dims = rec.params.get("dim")
    if len(shape) < 2 or shape[0] != ROW_CHUNK or dims is None:
        return False
    dims = [dims] if isinstance(dims, int) else list(dims)
    return bool(dims) and all(d % len(shape) != 0 for d in dims)


def _check_ops(record: StageRecord, cap: StageCapture) -> List[Finding]:
    found: List[Finding] = []
    n_corpus = int(cap.context.get("n_corpus", 0))
    for rec in record.ops:
        name = rec.op
        if name == "_local_scalar_dense":
            found.append(Finding(
                check="callback-prim", site=cap.site,
                detail="host read of a tensor value (.item() / int() / bool()) "
                       "inside a stage: a capture cannot hold it and a replay "
                       "never runs it",
                signature=("callback-prim", name)))
        elif (name in _COPY_OPS and rec.inputs and rec.outputs
              and any(u.device.startswith("cuda") for u in rec.inputs)
              and (rec.outputs[0].device == "cpu"
                   or (name == "copy_" and rec.inputs[0].device == "cpu"))):
            found.append(Finding(
                check="callback-prim", site=cap.site,
                detail=f"device-to-host copy '{rec.name}' inside a stage",
                signature=("callback-prim", "d2h-copy")))
        elif name in _RNG_OPS:
            found.append(Finding(
                check="rng-prim", site=cap.site,
                detail=f"random op '{rec.name}' inside a stage (every stream "
                       f"must resolve from the fingerprinted seed before the "
                       f"plan runs)",
                signature=("rng-prim", name)))
        elif name in _DOT_OPS and n_corpus and rec.outputs \
                and rec.outputs[0].dtype.startswith(("float", "bfloat", "complex")):
            dims = _dot_dims(rec)
            if dims is not None:
                lf, rf, nb, kc = dims
                if nb == 0 and rf >= n_corpus and lf != ROW_CHUNK:
                    dtype = rec.outputs[0].dtype
                    found.append(Finding(
                        check="full-scan-dot", site=cap.site,
                        detail=(
                            f"[{lf} x {kc}] @ [{kc} x {rf}] full-corpus float "
                            f"product '{rec.name}' outside the fixed "
                            f"{ROW_CHUNK}-row chunk (kernels/ref.py) and outside "
                            f"a hand-written kernel: a library product's last "
                            f"ulp varies with the batch shape"),
                        signature=("full-scan-dot", dtype)))
        elif name in _REDUCE_OPS and n_corpus and rec.inputs \
                and rec.inputs[0].dtype.startswith(("float", "bfloat", "complex")):
            reduced = _reduced_elements(rec)
            if reduced >= n_corpus and not _reduce_chunk_safe(rec):
                found.append(Finding(
                    check="full-reduce", site=cap.site,
                    detail=(
                        f"float reduction '{rec.name}' over {reduced} elements "
                        f"(corpus-scale) outside the pinned chunk structure: "
                        f"its order is shape-dependent"),
                    signature=("full-reduce", rec.inputs[0].dtype)))
        for use in rec.inputs + rec.outputs:
            if use.dtype in _X64_DTYPES:
                found.append(Finding(
                    check="x64-leak", site=cap.site,
                    detail=f"64-bit float tensor ({use.dtype}) in op "
                           f"'{rec.name}': scores stay f32 (int64 indices and "
                           f"key planes are exempt)",
                    signature=("x64-leak", use.dtype, name)))
    return found


def audit_ops(record: StageRecord, cap: StageCapture) -> List[Finding]:
    """All findings for one stage's op record (deduplicated, annotated with
    the invariant each check enforces)."""
    raw = _check_consts(record, cap) + _check_ops(record, cap)
    seen: Dict[str, Finding] = {}
    for f in raw:
        seen.setdefault(f.fingerprint(), f)
    return [annotate(f) for f in seen.values()]


def audit_captures(captures: Sequence[StageCapture]) -> List[Finding]:
    """Rerun and audit every capture; findings deduplicate across the whole
    grid by fingerprint (one entry per structural hazard).  Each capture's
    ``context["launches"]`` gets the kernels its rerun launched."""
    out: Dict[str, Finding] = {}
    for cap in captures:
        try:
            record = record_stage(cap)
        except Exception as exc:   # a stage that cannot rerun standalone is
            f = annotate(Finding(   # itself a hazard: stages are functions
                check="stage-failure", site=cap.site,
                detail=f"stage failed to rerun from its captured operands: {exc}",
                signature=("rerun-failure", type(exc).__name__)))
            out.setdefault(f.fingerprint(), f)
            continue
        cap.context["launches"] = record.launches
        for f in audit_ops(record, cap):
            out.setdefault(f.fingerprint(), f)
    return list(out.values())
