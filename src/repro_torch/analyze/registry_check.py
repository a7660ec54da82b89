"""Registry-vs-kernel consistency (NSF006) and dispatch floors (NSF007).

The port of ``repro.analyze.registry_check``.  The kernel registry
(``backend/registry.py``) makes claims about the hand-written kernels:
which source builds each, how far its output may drift from the exact
reference (``epsilon``), below which block dim it stops paying for itself
(``dispatch_min_size``).  The wrappers make more: which shapes a kernel
takes (they raise on the rest), and how much shared memory it needs.
This module checks those claims, two ways:

* **static**: every ``kernels/<dir>/ops.py`` is behind at least one
  registry entry and every entry names an existing dir (``circ_dict``
  lives in ``kernels/circ_conv``: :data:`KERNEL_DIRS` maps the entries
  to dirs explicitly); every entry's ``source`` exists under ``csrc/``
  and every ``csrc/*.cu`` has an entry; every kernel dir has its plain
  ``ref.py`` (the port's counterpart of a preference chain ending in the
  exact reference).  The shared-memory formulas kept twice, in the
  ``.cu`` and in the wrapper (``circ_conv/ops.py:dict_smem_bytes``,
  ``unbind_classify/ops.py:smem_bytes`` with its ``geometry``,
  ``simd_fused/ops.py:smem_bytes``), are read out of the ``.cu`` (its
  ``constexpr`` constants and the few-line functions that compute them,
  translated to Python) and held against the wrapper's at the probe
  shapes.  circ_conv's and flash_attn's shared memory is computed inside
  their ``launch`` functions' control flow and is not read statically;
  their wrappers refuse only far beyond the served sizes, which the
  probes' refused cases check.
* **empirical** (``probe=True``, CLI/tests: deploy()'s cheap preflight
  skips it): :func:`check_probes` sweeps each kernel at the reference's
  ``_PROBE_SIZES`` plus the dispatch floor 128 and 256 (flash_attn: head
  dims 64/128/256 at a short sequence that is no multiple of the tile,
  causal and not, f32 and bf16).  On the CPU each wrapper is called
  directly, below the floor too, so its plain ``ref.py`` version is held
  against the exact gather lowering the dispatch takes below the floor
  (circ_conv, circ_dict, unbind_classify, simd_fused; qmatmul and
  flash_attn have none).  On CUDA every wrapper launches its kernel and
  is held against its plain version, and against the gather lowering
  where one exists, within the registry's ``epsilon``: above it is an
  NSF006 error.  On CUDA each kernel is also called at one size its
  wrapper refuses: the wrapper must raise an error that names the size
  (it is never routed to the plain version), and the kernel's C entry
  point is then launched directly at that size.  The entry points check
  their own limits and return a CUDA error there; a direct launch that
  runs and conforms proves the wrapper's refusal over-strict (NSF006).
  After a refused direct launch the kernel is launched once more at an
  accepted size, which must succeed: an entry point that left its failed
  runtime call as the runtime's last error would have the next launch
  report it (NSF006).
  ``device="cuda"`` raises when there is no CUDA: the probes never run
  on the CPU instead.

NSF007 cross-checks declared ``dispatch_min_size`` floors against the
source tree: a floor no ``registry.dispatch_path(<kernel>, ...)`` call
site applies is dead perf policy; such a site for a floorless kernel is
a no-op: both warnings.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable

import torch

from repro_torch.analyze.findings import AnalysisReport, finding
from repro_torch.backend import registry
from repro_torch.backend.registry import KERNELS

_SRC_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                          os.pardir))
_KERNELS_DIR = os.path.join(_SRC_ROOT, "kernels")
_CSRC_DIR = os.path.join(_SRC_ROOT, "csrc")

# registry entry -> its dir under kernels/ (the name itself where absent)
KERNEL_DIRS = {"circ_dict": "circ_conv"}

# sizes the probes sweep: the reference's non-pow2 / sub-floor sizes and
# pow2 controls, then the dispatch floor and the served d
_PROBE_SIZES = (5, 12, 33, 8, 32)
PROBE_SIZES = _PROBE_SIZES + (128, 256)
FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_SEQ = 77                      # short, and no multiple of any tile


def kernel_dir(name: str) -> str:
    return KERNEL_DIRS.get(name, name)


# -- static ---------------------------------------------------------------


def _matching(text: str, start: int, open_: str, close: str) -> int:
    """Index just past the bracket closing the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        depth += {open_: 1, close: -1}.get(text[i], 0)
        if depth == 0:
            return i + 1
    raise ValueError(f"unbalanced {open_}{close}")


def _c_expr(expr: str) -> str:
    """A C integer expression as Python (integer division throughout)."""
    expr = " ".join(re.sub(r"static_cast<[^>]*>", "", expr).split())
    expr = re.sub(r"\b(\d+)(?:ull|ul|ll|u|l)\b", r"\1", expr, flags=re.I)
    expr = re.sub(r"\b(\w+)\.(\w+)\b", r"\1_\2", expr)
    expr = expr.replace("&&", " and ").replace("||", " or ").replace("/", "//")
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        yes, no = rest.split(":", 1)
        expr = f"({yes}) if ({cond}) else ({no})"
    return expr


def _c_statement(stmt: str, indent: str) -> list[str]:
    stmt = stmt.strip()
    m = re.match(r"(if|while)\s*\(", stmt)
    if m:
        end = _matching(stmt, m.end() - 1, "(", ")")
        cond = _c_expr(stmt[m.end():end - 1])
        return [f"{indent}{m.group(1)} {cond}:",
                *_c_statement(stmt[end:], indent + "    ")]
    if stmt.startswith("return "):
        return [f"{indent}return {_c_expr(stmt[7:])}"]
    m = re.fullmatch(r"(?:const\s+)?(?:int|size_t|long long)\s+(\w+)\s*=\s*(.+)",
                     stmt, re.S)
    if m:
        return [f"{indent}{m.group(1)} = {_c_expr(m.group(2))}"]
    m = re.fullmatch(r"([\w.]+)\s*([*+/-]?=)\s*(.+)", stmt, re.S)
    if m:
        return [f"{indent}{m.group(1).replace('.', '_')} {m.group(2)} "
                f"{_c_expr(m.group(3))}"]
    if re.fullmatch(r"\w+\s+\w+", stmt):       # a struct declaration
        return []
    raise ValueError(f"cannot read C statement {stmt!r}")


class CuSource:
    """The ``constexpr`` integer constants of one ``.cu`` file and its
    small host functions, translated to Python: ``fn(name)`` returns a
    callable; a function returning a struct ``g`` returns ``{field:
    value}``."""

    def __init__(self, path: str):
        with open(path) as f:
            self.text = f.read()
        self.env: dict = {}
        for m in re.finditer(r"constexpr\s+(?:int|size_t|unsigned)\s+(\w+)"
                             r"\s*=\s*([^;]+);", self.text):
            try:
                self.env[m.group(1)] = eval(_c_expr(m.group(2)), {},
                                            dict(self.env))
            except (NameError, SyntaxError):
                continue   # a constant that is no plain integer expression

    def fn(self, name: str) -> Callable:
        m = re.search(rf"^\w[\w\s]*\b{name}\(([^)]*)\)\s*\{{", self.text, re.M)
        if m is None:
            raise KeyError(f"no host function {name!r}")
        body = self.text[m.end():_matching(self.text, m.end() - 1, "{", "}")
                         - 1]
        params = [p.split()[-1] for p in m.group(1).split(",")]
        lines = [f"def {name}({', '.join(params)}):"]
        for stmt in body.split(";"):
            stmt = re.sub(r"//[^\n]*", "", stmt).strip()
            if stmt == "return g":
                lines.append("    return {k[2:]: v for k, v in locals()"
                             ".items() if k.startswith('g_')}")
            elif stmt:
                lines.extend(_c_statement(stmt, "    "))
        env = dict(self.env)
        exec("\n".join(lines), env)   # noqa: S102 - the repo's own .cu
        return env[name]


def _smem_twins() -> list[tuple[str, str, int, int]]:
    """(kernel, point, wrapper bytes, .cu bytes) of each twin formula at
    the probe shapes."""
    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.simd_fused import ops as simd_ops
    from repro_torch.kernels.unbind_classify import ops as uc_ops

    out = []
    cu = CuSource(os.path.join(_CSRC_DIR, KERNELS["circ_dict"].source))
    cols, smem = cu.env["WCOLS"], cu.fn("smem_bytes")
    out.append(("circ_dict", "WCOLS / WROWS", (circ_ops.DICT_COLS,
                circ_ops.DICT_MIN_ROWS), (cols, cu.env["WROWS"])))
    for d in PROBE_SIZES:
        for elt in (4, 2):
            for rows, entries in ((16, 1), (32, 2), (32, 8)):
                dp = -(-d // cols) * cols
                out.append(("circ_dict", f"d={d} elt={elt} rows={rows} "
                            f"entries={entries}",
                            circ_ops.dict_smem_bytes(d, elt, rows, entries),
                            smem(dp, rows, entries, elt == 2)))
    cu = CuSource(os.path.join(_CSRC_DIR, KERNELS["unbind_classify"].source))
    padded, splits, row = cu.fn("padded"), cu.fn("splits_for"), \
        cu.fn("row_bytes")
    out.append(("unbind_classify", "MAX_C", uc_ops.MAX_CLASSES,
                cu.env["MAX_C"]))
    out.append(("unbind_classify", "MAX_DYN_SMEM", uc_ops._MAX_SMEM,
                cu.env["MAX_DYN_SMEM"]))
    for d in PROBE_SIZES + (1024, 1088, 4096):
        dp = padded(d)
        out.append(("unbind_classify", f"geometry d={d}", uc_ops.geometry(d),
                    (dp, splits(dp))))
        for rows in (1, 3):
            out.append(("unbind_classify", f"d={d} rows={rows}",
                        uc_ops.smem_bytes(d, rows),
                        rows * row(dp, splits(dp))))
    cu = CuSource(os.path.join(_CSRC_DIR, KERNELS["simd_fused"].source))
    geometry = cu.fn("geometry")
    out.append(("simd_fused", "TQ / PASS / MAX_CLUSTER",
                (simd_ops.QUERY_TILE, simd_ops.PASS, simd_ops.MAX_CLUSTER),
                (cu.env["TQ"], cu.env["PASS"], cu.env["MAX_CLUSTER"])))
    for d in PROBE_SIZES:
        for blocks in (1, 4):
            for elt in (4, 2):
                for entries in (1, 16, 1000):
                    out.append((
                        "simd_fused", f"d={d} B={blocks} elt={elt} "
                        f"entries={entries}",
                        simd_ops.smem_bytes(entries, blocks, d, elt),
                        geometry(entries, 1, blocks, d, elt)["smem"]))
    return out


def check_static() -> AnalysisReport:
    report = AnalysisReport()
    kernels_dir = os.path.normpath(_KERNELS_DIR)
    dirs = sorted(
        d for d in os.listdir(kernels_dir)
        if os.path.isdir(os.path.join(kernels_dir, d))
        and os.path.exists(os.path.join(kernels_dir, d, "ops.py")))
    served = {kernel_dir(name) for name in KERNELS}
    for d in dirs:
        if d not in served:
            report.findings.append(finding(
                "NSF006", f"kernels/{d}",
                "kernel package has no registry entry: its launches are "
                "invisible to the counts, the records and trace replay"))
        if not os.path.exists(os.path.join(kernels_dir, d, "ref.py")):
            report.findings.append(finding(
                "NSF006", f"kernels/{d}",
                "kernel package has no plain ref.py: the CPU path and the "
                "card's yardstick are missing"))
    for name, spec in KERNELS.items():
        if kernel_dir(name) not in dirs:
            report.findings.append(finding(
                "NSF006", f"registry/{name}",
                f"registry entry has no kernels/{kernel_dir(name)}/ package "
                "(ops.py) behind it"))
        if not os.path.exists(os.path.join(_CSRC_DIR, spec.source)):
            report.findings.append(finding(
                "NSF006", f"registry/{name}",
                f"registry entry names csrc/{spec.source}, which does not "
                "exist"))
    sources = {spec.source for spec in KERNELS.values()}
    for f in sorted(os.listdir(_CSRC_DIR)):
        if f.endswith(".cu") and f not in sources:
            report.findings.append(finding(
                "NSF006", f"csrc/{f}",
                "CUDA source has no registry entry: nothing builds or "
                "counts it"))
    twins = _smem_twins()
    for kernel, point, ours, theirs in twins:
        if ours != theirs:
            report.findings.append(finding(
                "NSF006", f"registry/{kernel}",
                f"the wrapper's shared-memory formula disagrees with the "
                f".cu at {point}: {ours} vs {theirs}; the two copies "
                "drifted"))
    report.covered("registry_static", len(KERNELS))
    report.covered("smem_twins", len(twins))
    return report


# -- empirical probes -------------------------------------------------------


@dataclasses.dataclass
class ProbeCase:
    """One call of a kernel's wrapper at one size: ``run`` is the wrapper,
    ``plain`` its plain version, ``gather`` the exact lowering the dispatch
    takes below the floor (None where there is none)."""

    kernel: str
    label: str
    run: Callable
    plain: Callable
    gather: Callable | None = None


@dataclasses.dataclass
class RefusedCase:
    """A size the wrapper refuses: ``run`` must raise naming ``names``;
    ``direct`` launches the C entry point at it, ``plain`` is the plain
    version to hold a direct launch that runs against."""

    kernel: str
    label: str
    names: str
    run: Callable
    direct: Callable
    plain: Callable


@dataclasses.dataclass
class ProbeRow:
    """What the probes saw of one kernel: ``probed`` counts every size
    called, the ``refused`` ones included; the errors are None where
    nothing was compared (the plain version on the CPU, which is the
    wrapper itself)."""

    kernel: str
    epsilon: float
    probed: int = 0
    refused: int = 0
    max_err_plain: float | None = None
    max_err_gather: float | None = None

    def record(self) -> dict:
        return dataclasses.asdict(self)


def _cases(device: torch.device) -> list[ProbeCase]:
    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn import ref as flash_ref
    from repro_torch.kernels.qmatmul import ops as q_ops
    from repro_torch.kernels.qmatmul import ref as q_ref
    from repro_torch.kernels.simd_fused import ops as simd_ops
    from repro_torch.kernels.simd_fused import ref as simd_ref
    from repro_torch.kernels.unbind_classify import ops as uc_ops
    from repro_torch.kernels.unbind_classify import ref as uc_ref
    from repro_torch.nn import layers
    from repro_torch.vsa import ops as vsa

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    gather_elem = {"conv": vsa.circ_conv_ref, "corr": vsa.circ_corr_ref}
    cases = []
    for d in PROBE_SIZES:
        for mode in ("conv", "corr"):
            x, y = randn(2, 2, d), randn(2, 2, d)
            cases.append(ProbeCase(
                "circ_conv", f"{mode} d={d}",
                lambda x=x, y=y, m=mode: circ_ops.circ_elem(x, y, m),
                lambda x=x, y=y, m=mode: circ_ref.circ_elem_ref(x, y, m),
                lambda x=x, y=y, m=mode: gather_elem[m](x, y)))
        x, book = randn(3, 2, d), randn(4, 2, d)
        cases.append(ProbeCase(
            "circ_dict", f"d={d}",
            lambda x=x, b=book: circ_ops.circ_bind_dict(x, b),
            lambda x=x, b=book: circ_ref.circ_dict_ref(x, b).transpose(1, 2),
            lambda x=x, b=book: vsa.circ_conv_ref(x[:, None], b[None])))
        keys, codes = randn(3, 2, d), randn(4, 2 * d)
        head = {"w": randn(2 * d, 5, scale=0.1), "b": randn(5, scale=0.1)}

        def unbind_gather(head=head, keys=keys, codes=codes, d=d):
            shape = (4, 3, 2, d)
            u = vsa.circ_corr_ref(keys[None].expand(shape),
                                  codes.reshape(4, 1, 2, d).expand(shape))
            return layers.dense(head, u.reshape(4, 3, -1), torch.float32)

        cases.append(ProbeCase(
            "unbind_classify", f"d={d}",
            lambda h=head, k=keys, x=codes: uc_ops.unbind_classify(h, k, x),
            lambda h=head, k=keys, x=codes: uc_ref.unbind_classify_ref(h, k, x),
            unbind_gather))
        q, book = randn(5, 2, d), randn(7, 2, d)
        cases.append(ProbeCase(
            "simd_fused", f"d={d}",
            lambda q=q, b=book: simd_ops.fused_match_prob(q, b),
            lambda q=q, b=book: simd_ref.fused_match_prob_ref(q, b),
            lambda q=q, b=book: torch.softmax(vsa.similarity_matrix(q, b),
                                              dim=-1)))
        for int4 in (False, True):
            lim = 8 if int4 else 128
            xq = torch.randint(-128, 128, (4, d), generator=gen,
                               dtype=torch.int8).to(device)
            wq = torch.randint(-lim, lim, (d, 6), generator=gen,
                               dtype=torch.int8)
            wq = (q_ops.pack_int4(wq) if int4 else wq).to(device)
            xs = (torch.rand(4, generator=gen) + 0.01).to(device)
            ws = (torch.rand(6, generator=gen) + 0.01).to(device)
            args = (xq, wq, xs, ws, int4)
            cases.append(ProbeCase(
                "qmatmul", f"{'int4' if int4 else 'int8'} k={d}",
                lambda a=args: q_ops.qmatmul(*a),
                lambda a=args: q_ref.qmatmul_ref(*a)))
    for hd in FLASH_HEAD_DIMS:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (randn(2, FLASH_SEQ, 2, hd).to(dtype)
                           for _ in range(3))

                def flash_plain(q=q, k=k, v=v, causal=causal):
                    bh = lambda t: t.transpose(1, 2).reshape(  # noqa: E731
                        -1, t.shape[1], t.shape[3])
                    out = flash_ref.flash_attention_ref(
                        bh(q), bh(k), bh(v), scale=q.shape[-1] ** -0.5,
                        causal=causal)
                    return out.reshape(2, 2, FLASH_SEQ, -1).transpose(1, 2)

                cases.append(ProbeCase(
                    "flash_attn", f"hd={hd} s={FLASH_SEQ} "
                    f"{'causal' if causal else 'full'} "
                    f"{str(dtype).split('.')[1]}",
                    lambda q=q, k=k, v=v, c=causal: flash_ops.flash_mha(
                        q, k, v, q.shape[-1] ** -0.5, c),
                    flash_plain))
    return cases


def _refused(device: torch.device) -> list[RefusedCase]:
    """One size per kernel that its wrapper refuses, with a direct launch
    of its C entry point (CUDA only)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.qmatmul import ops as q_ops
    from repro_torch.kernels.qmatmul import ref as q_ref
    from repro_torch.kernels.simd_fused import ops as simd_ops
    from repro_torch.kernels.simd_fused import ref as simd_ref
    from repro_torch.kernels.unbind_classify import ops as uc_ops
    from repro_torch.kernels.unbind_classify import ref as uc_ref

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def direct(kernel, out, *args):
        """Launch ``kernel``'s C entry point on ``args``, bypassing its
        wrapper; returns ``out``."""
        def run():
            idx = out.get_device()
            _build.launch(kernel, idx, *(a.data_ptr() if isinstance(
                a, torch.Tensor) else a for a in args))
            return out
        return run

    cases = []
    d = 32768   # circ_elem's one-tile block: 4 (3 dp + 64 S) bytes > 227 KB
    x, y, out = ones(1, 1, d), ones(1, 1, d), zeros(1, 1, d)
    cases.append(RefusedCase(
        "circ_conv", f"d={d}", f"d={d}", lambda: circ_ops.circ_elem(x, y),
        direct("circ_conv", out, x, y, out, 1, 1, d, d, d, d, d, 0, 0),
        lambda: circ_ref.circ_elem_ref(x, y)))
    d = circ_ops.DICT_MAX_D + circ_ops.DICT_COLS
    xd, book, outd = ones(1, 1, d), ones(1, 1, d), zeros(1, 1, 1, d)
    cases.append(RefusedCase(
        "circ_dict", f"d={d}", f"d={d}",
        lambda: circ_ops.circ_bind_dict(xd, book),
        direct("circ_dict", outd, xd, book, outd, 1, 1, 1, d, 0, 0),
        lambda: circ_ref.circ_dict_ref(xd, book).transpose(1, 2)))
    c = uc_ops.MAX_CLASSES + 1
    keys, xu, w, b = ones(1, 1, 128), ones(1, 1, 128), ones(1, 128, c), \
        zeros(1, c)
    outu = zeros(1, 1, c)
    cases.append(RefusedCase(
        "unbind_classify", f"C={c}", str(c),
        lambda: uc_ops.fused_unbind_classify(keys, xu, w, b),
        direct("unbind_classify", outu, keys, xu, w, b, outu, 1, 1, 1, 128, c),
        lambda: uc_ref.fused_unbind_classify_ref(keys, xu, w, b)))
    m = simd_ops.max_entries(1, 8) + 1
    qs, books, outs = ones(1, 1, 8), ones(m, 1, 8), zeros(1, m)
    cases.append(RefusedCase(
        "simd_fused", f"M={m}", f"M={m}",
        lambda: simd_ops.fused_match_prob(qs, books),
        direct("simd_fused", outs, qs, books, outs, 1, m, 1, 8,
               simd_ops.cluster_size(1, m, 1, 8), 1.0, 0),
        lambda: simd_ref.fused_match_prob_ref(qs, books)))
    hd = flash_ops.MAX_HEAD_DIM + 64
    qf = ones(1, 8, 1, hd)
    outf = torch.empty_like(qf)
    cases.append(RefusedCase(
        "flash_attn", f"hd={hd}", str(hd),
        lambda: flash_ops.flash_mha(qf, qf, qf, 1.0),
        direct("flash_attn", outf, qf, qf, qf, outf, 1, 8, 8, 1, hd, 1.0, 1, 0),
        lambda: qf))   # attention over equal rows returns them
    mq = 65535 * q_ops._BLOCK_M + 1   # one row past the grid's 65535 blocks
    xq, wq = zeros(mq, 16, dtype=torch.int8), zeros(16, 2, dtype=torch.int8)
    xs, ws, outq = ones(mq), ones(2), zeros(mq, 2)
    cases.append(RefusedCase(
        "qmatmul", f"M={mq}", str(mq),
        lambda: q_ops.qmatmul(xq, wq, xs, ws),
        direct("qmatmul", outq, xq, wq, xs, ws, outq, mq, 2, 16, 0),
        lambda: q_ref.qmatmul_ref(xq, wq, xs, ws)))
    return cases


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def run_probes(device=None) -> tuple[AnalysisReport, list[ProbeRow]]:
    """The empirical NSF006 probes on ``device`` (None = ``"cuda"``, which
    raises without CUDA).  Returns the report and one row per kernel."""
    dev = registry.resolve_device(device)
    on_card = dev.type == "cuda"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 plain versions
    try:
        return _run_probes(dev, on_card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _run_probes(dev: torch.device, on_card: bool
                ) -> tuple[AnalysisReport, list[ProbeRow]]:
    report = AnalysisReport()
    rows = {name: ProbeRow(name, max(spec.epsilon, 1e-5))
            for name, spec in KERNELS.items()}
    cases = _cases(dev)
    for case in cases:
        row = rows[case.kernel]
        where = f"{case.kernel}/{dev.type}@{case.label}"
        if not on_card and case.gather is None:
            continue   # on the CPU the wrapper is its plain version
        with torch.no_grad():
            got = case.run()
            errs = {"gather": _err(got, case.gather())} if case.gather \
                else {}
            if on_card:
                errs["plain"] = _err(got, case.plain())
                torch.cuda.synchronize(dev)
        row.probed += 1
        report.covered("kernel_probes")
        if "plain" in errs:
            row.max_err_plain = max(row.max_err_plain or 0.0, errs["plain"])
        if "gather" in errs:
            row.max_err_gather = max(row.max_err_gather or 0.0,
                                     errs["gather"])
        for against, err in errs.items():
            if not err <= row.epsilon:   # a NaN fails too
                report.findings.append(finding(
                    "NSF006", where,
                    f"{'kernel' if on_card else 'plain version'} drifts "
                    f"{err:.2e} from the {against} lowering at "
                    f"{case.label}: above the declared epsilon "
                    f"{KERNELS[case.kernel].epsilon:g}"))
    for case in _refused(dev) if on_card else ():
        row = rows[case.kernel]
        where = f"{case.kernel}/{dev.type}@{case.label}"
        report.covered("kernel_probes")
        try:
            with torch.no_grad():
                case.run()
        except (ValueError, TypeError) as e:
            row.probed += 1
            row.refused += 1
            report.covered("kernel_probes_refused")
            if case.names not in str(e):
                report.findings.append(finding(
                    "NSF006", where,
                    f"the wrapper refuses {case.label} without naming it: "
                    f"{e}"))
        else:
            report.findings.append(finding(
                "NSF006", where,
                f"the wrapper takes {case.label}, which its kernel's limits "
                "should refuse"))
            continue
        try:
            got = case.direct()
            torch.cuda.synchronize(dev)
        except RuntimeError:
            # the entry point refuses it too: the refusal holds, and the
            # kernel's next launch must not inherit the failure
            follow = next(c for c in cases if c.kernel == case.kernel)
            try:
                with torch.no_grad():
                    follow.run()
                torch.cuda.synchronize(dev)
            except RuntimeError as e:
                report.findings.append(finding(
                    "NSF006", where,
                    f"after the refused direct launch at {case.label}, the "
                    f"next launch ({follow.label}) fails: {e}"))
            continue
        with torch.no_grad():
            err = _err(got, case.plain())
        if err <= row.epsilon:
            report.findings.append(finding(
                "NSF006", where,
                f"refused by the wrapper at {case.label}, but a direct "
                f"launch conforms there ({err:.2e}): the wrapper's shape "
                "predicate is over-strict"))
    return report, list(rows.values())


def check_probes(device=None) -> AnalysisReport:
    """The empirical NSF006 probes' report (see :func:`run_probes`)."""
    return run_probes(device)[0]


# -- NSF007: dispatch floors vs call sites ------------------------------------

_DISPATCH_RE = re.compile(r"""dispatch_path\(\s*["'](?P<kernel>\w+)["']""")


def check_dispatch_floors(src_root: str | None = None) -> AnalysisReport:
    report = AnalysisReport()
    root = src_root or _SRC_ROOT
    sites: set[str] = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for m in _DISPATCH_RE.finditer(f.read()):
                    sites.add(m.group("kernel"))
    for name, spec in KERNELS.items():
        if spec.dispatch_min_size and name not in sites:
            report.findings.append(finding(
                "NSF007", f"registry/{name}",
                f"declares dispatch_min_size={spec.dispatch_min_size} but "
                "no registry.dispatch_path call site names it: the perf "
                "floor is dead policy"))
        if not spec.dispatch_min_size and name in sites:
            report.findings.append(finding(
                "NSF007", f"registry/{name}",
                "has registry.dispatch_path call sites but no "
                "dispatch_min_size floor: the dispatch is a no-op there"))
    report.covered("dispatch_floors", len(KERNELS))
    return report


def check_registry(probe: bool = False, device=None) -> AnalysisReport:
    """NSF006 static (+ empirical on ``device`` when ``probe``) and NSF007."""
    report = check_static()
    report.merge(check_dispatch_floors())
    if probe:
        report.merge(check_probes(device))
    return report
