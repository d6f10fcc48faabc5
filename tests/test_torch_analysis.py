"""The port's contract linter, ``repro_torch.analysis``: its five rules on
fixture trees in the port's idioms, the suppressions, the gate on the real
tree, the runtime half of predicate-purity, and parity with the JAX
package's linter where the two contracts are the same.

Contracts under test:

* each rule fires on a minimal known-bad fixture tree with the exact rule
  id and file:line, and stays silent on the legal forms next to it;
* host-sync knows torch's syncs (``.tolist()``, ``.cpu()``, ops with a
  data-dependent output size, boolean mask indexing, branching on
  ``.any()``), exempts Python-scalar parameters, follows the string kernel
  seam with receiver binding, and skips a wrapper's CPU branch;
* grid-contract reads the CUDA sources: an undeclared kernel, a sequential
  kernel reached from a concurrent backend, a look-back kernel reached
  without look-back compaction, and a carry in a concurrent kernel;
* the port's tree is clean: ``python -m repro_torch.analysis`` exits 0;
* ``verify_elementwise`` (meta tensors) accepts every spec kind the
  pattern compiler makes and rejects shape-bending, branching and
  host-reading hooks;
* two apps whose plan keys are equal have equal ``to_add_spec`` (the
  plan-signature suppression's reason).
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import run_analysis as jax_run_analysis
from repro.analysis.core import SourceFile as JaxSourceFile
from repro_torch.analysis import RULES, register_builtin_rules, run_analysis
from repro_torch.analysis.core import SourceFile

register_builtin_rules()

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
PORT_SRC = os.path.join(SRC, "repro_torch")


def _tree(tmp_path, files, package="repro_torch"):
    """Materialize ``{relpath: source}`` under a root named ``package``."""
    root = tmp_path / package
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(root)


def _findings(root, rule):
    _, fs = run_analysis(root, [rule])
    return fs


def _where(fs):
    return [(f.rule, f.path, f.line) for f in fs]


# ---------------------------------------------------------------------------
# host-sync


# (body lines of a function on the replay path; the last one syncs, or
# the first where the body is a branch)
SYNCS = {
    "item": ["return x.item()"],
    "tolist": ["return x.tolist()"],
    "cpu": ["return x.cpu()"],
    "numpy": ["return x.numpy()"],
    "to-cpu": ["return x.to('cpu')"],
    "to-device-cpu": ["return x.to(device=torch.device('cpu'))"],
    "cuda-synchronize": ["torch.cuda.synchronize()"],
    "event-synchronize": ["ev = torch.cuda.Event()", "ev.synchronize()"],
    "nonzero": ["return torch.nonzero(x)"],
    "nonzero-method": ["return x.nonzero()"],
    "argwhere": ["return torch.argwhere(x)"],
    "unique": ["return torch.unique(x)"],
    "unique-consecutive": ["return x.unique_consecutive()"],
    "masked-select": ["return torch.masked_select(x, x > 0)"],
    "repeat-interleave": ["return torch.repeat_interleave(x, x)"],
    "repeat-interleave-method": ["return x.repeat_interleave(x)"],
    "where-one-arg": ["return torch.where(x > 0)"],
    "mask-compare": ["return x[x > 0]"],
    "mask-name": ["live = x < 3", "keep = ~live & (x > 0)",
                  "return x[keep]"],
    "mask-bool": ["m = x.bool()", "return x[:, m]"],
    "if-any": ["if (x > 0).any():", "    return x"],
    "while-all": ["while x.all():", "    x = x - 1"],
    "np-asarray": ["return np.asarray(x)"],
    "tensor-to-device": ["return torch.tensor([1, 2], device=x.device)"],
    "as-tensor-to-device":
        ["return torch.as_tensor(k, dtype=torch.int32, device=x.device)"],
    "from-numpy": ["return torch.from_numpy(np.zeros(3)).to(x.device)"],
    "int-of-tensor": ["return int(x.sum())"],
    "bool-of-tensor": ["return bool(x.max() > 0)"],
}

# the same places with the legal forms: static shapes and host values
NO_SYNCS = {
    "int-param": ["return x + int(k)"],
    "float-default": ["return x * float(scale)"],
    "host-container": ["out = []", "for c, o in caps:",
                       "    c = min(int(c), CAP)", "    out.append(c)",
                       "return out"],
    "shape": ["return x.new_zeros(int(x.shape[0]) + len(x))"],
    "numel": ["return float(x.numel())"],
    "repeat-interleave-output-size":
        ["return torch.repeat_interleave(x, x, output_size=8)"],
    "repeat-interleave-constant": ["return x.repeat_interleave(2)"],
    "where-three-args": ["return torch.where(x > 0, x, 0)"],
    "index-int": ["i = torch.arange(3)", "return x[i] + x[k]"],
    "mask-store-scalar": ["x[x > 0] = 0", "return x"],
    "none-test": ["m = x if k is None else x + 1", "return m"],
    "any-builtin": ["if any(c for c in caps):", "    return x"],
    "tensor-on-host": ["return torch.tensor([1, 2]).sum() + x"],
    "full-on-device":
        ["return torch.full((), k, dtype=torch.int32, device=x.device)"],
}


def _replay_fixture(lines):
    body = "".join(f"    {line}\n" for line in lines)
    return {"core/engine.py": (
        "import numpy as np\n"
        "import torch\n"
        "\n"
        "CAP = 1 << 30\n"
        "\n"
        "\n"
        "def helper(x, k: int, scale=1.0,\n"
        "           caps: tuple[tuple[int, int], ...] = ()):\n"
        + body +
        "\n"
        "\n"
        "def run_level_loop(pipe, policy):\n"
        "    return helper(pipe, 3)\n")}


@pytest.mark.parametrize("case", sorted(SYNCS))
def test_host_sync_flags_torch_syncs(tmp_path, case):
    lines = SYNCS[case]
    fs = _findings(_tree(tmp_path, _replay_fixture(lines)), "host-sync")
    # helper's body starts on line 9
    at = 9 if lines[0].startswith(("if ", "while ")) else 8 + len(lines)
    assert _where(fs) == [("host-sync", "core/engine.py", at)], \
        [f.format() for f in fs]


@pytest.mark.parametrize("case", sorted(NO_SYNCS))
def test_host_sync_exempts_static_and_host_values(tmp_path, case):
    root = _tree(tmp_path, _replay_fixture(NO_SYNCS[case]))
    fs = _findings(root, "host-sync")
    assert fs == [], [f.format() for f in fs]


def test_host_sync_follows_calls_and_honors_guards(tmp_path):
    # the JAX test's counterpart: a guarded sync, a static coercion and
    # the sync past them, reached from a replay root
    root = _tree(tmp_path, {"core/engine.py": """\
        import numpy as np


        def helper(x, host):
            k = int(x.shape[0])
            if host:
                print(float(x))
            return np.asarray(x)


        def bounded_mine_vertex(x):
            return helper(x, False)
        """})
    assert _where(_findings(root, "host-sync")) == [
        ("host-sync", "core/engine.py", 8)]


def test_host_sync_guard_raise_keeps_the_rest_on_the_path(tmp_path):
    # `if policy.traceable and collect_stats: raise` leaves the rest of the
    # level loop on the replay path; `if not _T.on: return` does not
    root = _tree(tmp_path, {"core/engine.py": """\
        from repro_torch.obs import trace as _T


        def run_level_loop(pipe, policy, collect_stats=False):
            if policy.traceable and collect_stats:
                raise ValueError("stats need the host policy")
            return pipe.n.item()


        def span_op(x):
            if not _T.on:
                return x
            return x.item()


        def bounded_mine_edge(x):
            return span_op(x)
        """, "obs/trace.py": "on = False\n"})
    assert _where(_findings(root, "host-sync")) == [
        ("host-sync", "core/engine.py", 7)]


def test_host_sync_skips_a_wrappers_cpu_branch(tmp_path):
    root = _tree(tmp_path, {
        "kernels/fam/ref.py": """\
            def plain(x):
                return x.nonzero()
            """,
        "kernels/fam/ops.py": """\
            from repro_torch.kernels.fam import ref


            def wrapper(x):
                dev = x.device
                if dev.type == "cpu":
                    return ref.plain(x)
                return x.tolist()


            def other(x):
                if x.device.type != "cpu":
                    return x
                return ref.plain(x)
            """})
    assert _where(_findings(root, "host-sync")) == [
        ("host-sync", "kernels/fam/ops.py", 8)]


def test_host_sync_roots_and_seams(tmp_path):
    """``MiningExecutor._run_once`` is a root, a module imported inside a
    method resolves, ``traceable = False`` classes are not entered, and the
    string kernel seam resolves per receiver class."""
    root = _tree(tmp_path, {
        "core/plan.py": """\
            class HostCapPolicy:
                traceable = False

                def extend_caps(self, pipe):
                    return int(pipe.n)


            class MiningExecutor:
                def _run_once(self, x):
                    from repro_torch.core import engine as E
                    return E.replay(x)
            """,
        "core/engine.py": """\
            def replay(x):
                return x.cpu()


            def run_level_loop(pipe, policy):
                return policy.extend_caps(pipe)
            """,
        "core/seams.py": """\
            def fast(x):
                return x + 1


            def slow(x):
                return x.item()
            """,
        "core/phases/cuda.py": """\
            from repro_torch.core import seams


            class PhaseBackend:
                pass


            class Base(PhaseBackend):
                _kernel = "fast"

                def extend_pruned(self, x):
                    return getattr(seams, self._kernel)(x)


            class Sub(Base):
                _kernel = "slow"
            """})
    assert _where(_findings(root, "host-sync")) == [
        ("host-sync", "core/engine.py", 2),
        ("host-sync", "core/seams.py", 6)]


def test_host_sync_replay_hooks_are_roots(tmp_path):
    # a hook handed to MiningApp(...) runs inside every replay
    root = _tree(tmp_path, {"core/apps/mc.py": """\
        from repro_torch.core.api import MiningApp


        def make_app():
            def get_pattern(ctx, emb, state, valid):
                return emb.nonzero(), state
            return MiningApp(name="x", get_pattern=get_pattern)
        """})
    assert _where(_findings(root, "host-sync")) == [
        ("host-sync", "core/apps/mc.py", 6)]


# ---------------------------------------------------------------------------
# grid-contract: the CUDA sources


def _cuda_tree(tmp_path, kernel_a, compaction="two-pass-scan",
               contract_b="concurrent"):
    return _tree(tmp_path, {
        "kernels/fam/ops.py": """\
            def _lib():
                return None


            def run_a(x):
                lib = _lib()
                launch("a", lib.entry_a, lib.fam_error_string, x)


            def run_b(x):
                _launch("b", _lib().entry_b, x)
            """,
        "kernels/fam/csrc/fam.cu": kernel_a + textwrap.dedent(f"""\

            template <int M>
            // repro: grid[{contract_b}]
            __global__ void kern_b(int* x) {{ x[threadIdx.x] = M; }}

            extern "C" {{
            int entry_a(int* x, void* s) {{
              kern_a<<<1, 32, 0, (cudaStream_t)s>>>(x);
              return 0;
            }}
            int entry_b(int* x, void* s) {{
              kern_b<1><<<1, 32, 0, (cudaStream_t)s>>>(x);
              return 0;
            }}
            }}  // extern "C"
            """),
        "core/phases/cuda.py": f"""\
            from repro_torch.kernels.fam import ops


            class Backend:
                grid_contract = "concurrent"
                compaction = "{compaction}"

                def extend(self, x):
                    return ops.run_b(x)
            """})


PLAIN_A = """\
// repro: grid[concurrent]
__global__ void kern_a(int* x) { x[threadIdx.x] += 1; }
"""


@pytest.mark.parametrize("case", ["undeclared", "sequential", "lookback",
                                  "spin"])
def test_grid_contract_cuda_cases(tmp_path, case):
    kernel_a, contract_b, where = PLAIN_A, "concurrent", None
    if case == "undeclared":
        kernel_a = "__global__ void kern_a(int* x) { x[0] = 1; }\n"
        where = ("kernels/fam/csrc/fam.cu", 1)
    elif case in ("sequential", "lookback"):
        contract_b = case
        where = ("core/phases/cuda.py", 5)
    else:
        kernel_a = textwrap.dedent("""\
            __device__ unsigned load_flag(const unsigned* p) {
              unsigned v;
              asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                           : "=r"(v) : "l"(p) : "memory");
              return v;
            }

            // repro: grid[concurrent]
            __global__ void kern_a(unsigned* flags) {
              if (blockIdx.x == 0) return;
              while (load_flag(flags + blockIdx.x - 1) == 0) {
              }
            }
            """)
        where = ("kernels/fam/csrc/fam.cu", 9)
    fs = _findings(_cuda_tree(tmp_path, kernel_a, contract_b=contract_b),
                   "grid-contract")
    assert [(f.path, f.line) for f in fs] == [where], \
        [f.format() for f in fs]
    if case in ("sequential", "lookback"):
        assert f"grid[{case}] kernel 'kern_b'" in fs[0].message
        assert "run_b() -> entry_b" in fs[0].message


CARRIES = {
    "volatile-spin": ("__global__ void kern_a(volatile int* f) {\n"
                      "  while (f[0] == 0) {}\n}\n", True),
    "atomic-cas": ("__global__ void kern_a(int* f) {\n"
                   "  atomicCAS(f, 0, 1);\n}\n", True),
    "atomic-add-used": ("__global__ void kern_a(int* f, int* o) {\n"
                        "  int t = atomicAdd(f, 1);\n  o[t] = 1;\n}\n",
                        True),
    "atomic-add-unused": ("__global__ void kern_a(float* acc, float v) {\n"
                          "  if (threadIdx.x <= 3) atomicAdd(acc, v);\n"
                          "}\n", False),
    "asm-volatile-barrier": (
        "__global__ void kern_a(int* x) {\n"
        "  for (int i = 0; i < 4; ++i)\n"
        "    asm volatile(\"bar.sync 0;\" ::: \"memory\");\n}\n", False),
}


@pytest.mark.parametrize("case", sorted(CARRIES))
def test_grid_contract_concurrent_carries(tmp_path, case):
    body, flagged = CARRIES[case]
    fs = _findings(_cuda_tree(tmp_path, "// repro: grid[concurrent]\n"
                              + body), "grid-contract")
    assert [(f.path, f.line) for f in fs] == (
        [("kernels/fam/csrc/fam.cu", 2)] if flagged else []), \
        [f.format() for f in fs]


def test_grid_contract_lookback_with_lookback_compaction(tmp_path):
    fs = _findings(_cuda_tree(tmp_path, PLAIN_A, "decoupled-lookback",
                              "lookback"), "grid-contract")
    assert fs == []


def test_grid_contract_string_seam_is_receiver_bound(tmp_path):
    # the cuda-1p idiom: only the subclass's seam names the look-back
    # wrapper, and only the subclass runs look-back compaction
    root = _cuda_tree(tmp_path, PLAIN_A, contract_b="lookback")
    (tmp_path / "repro_torch" / "core" / "phases" / "cuda.py").write_text(
        textwrap.dedent("""\
            from repro_torch.kernels.fam import ops


            class PairBackend:
                grid_contract = "concurrent"
                compaction = "two-pass-scan"
                _kernel = "run_a"

                def extend(self, x):
                    return getattr(ops, self._kernel)(x)


            class OnePassBackend(PairBackend):
                compaction = "decoupled-lookback"
                _kernel = "run_b"
            """))
    assert _findings(root, "grid-contract") == []
    text = (tmp_path / "repro_torch" / "core" / "phases" /
            "cuda.py").read_text()
    (tmp_path / "repro_torch" / "core" / "phases" / "cuda.py").write_text(
        text.replace('_kernel = "run_a"', '_kernel = "run_b"'))
    assert _where(_findings(root, "grid-contract")) == [
        ("grid-contract", "core/phases/cuda.py", 5)]


# ---------------------------------------------------------------------------
# obs-purity


def test_obs_purity_flags_unguarded_span_in_phases(tmp_path):
    root = _tree(tmp_path, {
        "obs/trace.py": "on = False\n",
        "core/phases/bad.py": """\
            from repro_torch.obs import trace as _T


            def extend_op(x):
                _T.instant("extend", n=3)
                if _T.on:
                    _T.instant("guarded-fine", n=4)
                return x
            """})
    assert _where(_findings(root, "obs-purity")) == [
        ("obs-purity", "core/phases/bad.py", 5)]


def test_obs_purity_bans_obs_import_in_kernels(tmp_path):
    root = _tree(tmp_path, {
        "obs/metrics.py": "def inc(*a, **k): pass\n",
        "kernels/fam/ops.py": """\
            from repro_torch.obs import metrics


            def wrapper(x):
                return x
            """})
    assert _where(_findings(root, "obs-purity")) == [
        ("obs-purity", "kernels/fam/ops.py", 1)]


def test_obs_purity_flags_the_replay_set_not_the_executor(tmp_path):
    root = _tree(tmp_path, {
        "obs/trace.py": "on = False\n",
        "core/plan.py": """\
            from repro_torch.obs import metrics as _M
            from repro_torch.obs import trace as _T


            class MiningExecutor:
                def _run_once(self, x):
                    _M.inc("executor.replays")
                    return x

                def _run_with_retry(self, x):
                    with _T.span("executor.replay"):
                        return self._run_once(x)
            """, "obs/metrics.py": "def inc(*a): pass\n"})
    assert _where(_findings(root, "obs-purity")) == [
        ("obs-purity", "core/plan.py", 7)]


# ---------------------------------------------------------------------------
# plan-signature


PLAN_FIXTURE = """\
import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class MiningApp:
    kind: str = 'vertex'
    widget: int = 0
    to_add: Optional[Callable] = None
    backend: Optional[str] = None


def plan_app_key(app, backend_name):
    return (app.kind, backend_name)
"""


def test_plan_signature_flags_undigested_field(tmp_path):
    root = _tree(tmp_path, {"core/plan.py": PLAN_FIXTURE})
    fs = _findings(root, "plan-signature")
    assert _where(fs) == [("plan-signature", "core/plan.py", 8)]
    assert "widget" in fs[0].message


def test_plan_signature_checks_the_transfer_key_too(tmp_path):
    root = _tree(tmp_path, {"core/plan.py": PLAN_FIXTURE.replace(
        "(app.kind, backend_name)", "(app.kind, app.widget, backend_name)")
        + "\n\ndef plan_transfer_key(app):\n    return (app.kind,)\n"})
    fs = _findings(root, "plan-signature")
    assert _where(fs) == [("plan-signature", "core/plan.py", 8)]
    assert "plan_transfer_key()" in fs[0].message
    assert "plan_app_key()" not in fs[0].message


def test_plan_signature_live_on_real_tree(tmp_path):
    """A synthetic undigested MiningApp field is caught on the port's own
    tree, at its definition line."""
    copy = tmp_path / "repro_torch"
    shutil.copytree(PORT_SRC, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    api = copy / "core" / "api.py"
    text = api.read_text()
    anchor = "    backend: Optional[str] = None"
    assert anchor in text
    api.write_text(text.replace(
        anchor, "    synthetic_knob: int = 0\n" + anchor, 1))
    fs = _findings(str(copy), "plan-signature")
    assert len(fs) == 1 and fs[0].path == "core/api.py"
    assert "synthetic_knob" in fs[0].message
    assert "synthetic_knob" in api.read_text().splitlines()[fs[0].line - 1]


# ---------------------------------------------------------------------------
# predicate-purity


def test_predicate_purity_flags_tensor_branch(tmp_path):
    root = _tree(tmp_path, {"core/apps/x.py": """\
        import torch


        def pred(emb_cols, u, src_slot, state, conn):
            ok = conn[0]
            for j in range(len(emb_cols)):
                ok = ok & (u != emb_cols[j])
            if state > 0:
                ok = ~ok
            if src_slot is not None:
                ok = ok & (src_slot == 0)
            return ok
        """})
    fs = _findings(root, "predicate-purity")
    assert _where(fs) == [("predicate-purity", "core/apps/x.py", 8)]
    assert "torch.where" in fs[0].message


def test_predicate_purity_finds_hooks_by_kwarg(tmp_path):
    root = _tree(tmp_path, {"core/apps/x.py": """\
        def mypred(ctx, cols, cand, slot, st):
            for c in cols:
                if cand == c:
                    return cand.item()
            return cand


        def build(MiningApp):
            return MiningApp(to_add=mypred)
        """})
    # `cols` is no known tuple parameter, so iterating it is flagged too
    assert _where(_findings(root, "predicate-purity")) == [
        ("predicate-purity", "core/apps/x.py", 2),
        ("predicate-purity", "core/apps/x.py", 3),
        ("predicate-purity", "core/apps/x.py", 4)]


def test_predicate_purity_spec_fields_are_static(tmp_path):
    # the port's spec classes branch on their own integer fields
    root = _tree(tmp_path, {"core/api.py": """\
        class PredicateSpec:
            required = 0
            label = -1

            def __call__(self, emb_cols, u, src_slot, state, conn,
                         lab_cols=None, lab_u=None):
                ok = u >= 0
                if self.label >= 0:
                    ok = ok & (lab_u == self.label)
                for j in range(len(emb_cols)):
                    if self.required >> j & 1:
                        ok = ok & conn[j]
                return ok


        class BranchSetSpec:
            branches = ()

            def bits(self, emb_cols, u, src_slot, state, conn):
                out = u * 0
                for b, br in enumerate(self.branches):
                    if br.first_pair:
                        out = out | (emb_cols[0] < emb_cols[1])
                return out
        """})
    assert _findings(root, "predicate-purity") == []


# ---------------------------------------------------------------------------
# suppressions, markers, the real tree and the CLI


def test_suppression_is_line_and_rule_scoped(tmp_path):
    src = textwrap.dedent("""\
        def run_level_loop(pipe, policy):
            a = pipe.sum().item()  # repro: ignore[host-sync]
            b = pipe.max().item()  # repro: ignore[grid-contract]
            return a + b
        """)
    fs = _findings(_tree(tmp_path, {"core/engine.py": src}), "host-sync")
    assert [(f.path, f.line) for f in fs] == [("core/engine.py", 3)]


def test_cuda_suppression(tmp_path):
    kernel = ("// repro: ignore[grid-contract] fixture\n"
              "__global__ void kern_a(int* x) { x[0] = 1; }\n")
    fs = _findings(_cuda_tree(tmp_path, kernel), "grid-contract")
    assert [(f.path, f.line) for f in fs] == [("kernels/fam/csrc/fam.cu", 2)]
    kernel = ("__global__ void kern_a(int* x) { x[0] = 1; }"
              "  // repro: ignore[grid-contract]\n")
    assert _findings(_cuda_tree(tmp_path, kernel), "grid-contract") == []


def test_host_module_marker_exempts_module(tmp_path):
    root = _tree(tmp_path, {
        "kernels/build.py": """\
            # repro: host-module
            def load(path):
                return int(open(path).read())
            """,
        "kernels/fam/ops.py": """\
            from repro_torch.kernels import build


            def wrapper(x):
                build.load("lib")
                return x
            """})
    assert _findings(root, "host-sync") == []


@pytest.mark.parametrize("text", [
    "x = 1  # repro: ignore[host-sync]\n",
    "x = 1  # repro: ignore[host-sync, plan-signature]\n",
    "x = 1  # repro: ignore[]\n",
    "# repro: host-module\nx = 1\n",
    "# repro: ignore\nx = 1  #repro:ignore[obs-purity]\n",
])
def test_suppression_parsing_matches_jax(text):
    port, jax = SourceFile("f.py", "f.py", text), JaxSourceFile(
        "f.py", "f.py", text)
    assert (port.suppressions, port.markers) == (jax.suppressions,
                                                  jax.markers)
    assert port.is_host_module == jax.is_host_module


def test_plan_signature_and_json_schema_match_jax(tmp_path):
    from repro.analysis import render_json as jax_render_json
    from repro_torch.analysis import render_json
    files = {"core/plan.py": PLAN_FIXTURE}
    jp, jf = jax_run_analysis(_tree(tmp_path, files, "repro"),
                              ["plan-signature"])
    pp, pf = run_analysis(_tree(tmp_path, files), ["plan-signature"])
    assert [(f.rule, f.path, f.line, f.col, f.message) for f in pf] == \
        [(f.rule, f.path, f.line, f.col, f.message) for f in jf]
    jd, pd = json.loads(jax_render_json(jp, jf)), json.loads(
        render_json(pp, pf))
    assert set(jd) <= set(pd) and pd["checked_cuda_files"] == 0
    assert pd["checked_files"] == jd["checked_files"] == 1
    assert pd["findings"] == jd["findings"]


def test_port_tree_is_clean():
    project, findings = run_analysis(PORT_SRC)
    assert project.errors == []
    assert len(project.cuda_files) >= 4
    assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_exit_codes_and_json(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            capture_output=True, text=True, env=env, timeout=60)

    bad = _tree(tmp_path, {"core/engine.py": (
        "def run_level_loop(pipe, policy):\n    return pipe.tolist()\n")})
    out = cli(bad, "--format", "json", "--output",
              str(tmp_path / "report.json"))
    assert out.returncode == 1
    doc = json.loads(out.stdout)
    assert set(doc) == {"root", "checked_files", "checked_cuda_files",
                        "parse_errors", "findings"}
    assert doc["checked_files"] == 1 and doc["checked_cuda_files"] == 0
    assert [f["rule"] for f in doc["findings"]] == ["host-sync"]
    assert set(doc["findings"][0]) == {"rule", "path", "line", "col",
                                       "message"}
    assert json.loads((tmp_path / "report.json").read_text()) == doc

    assert cli(bad, "--rules", "host-sync").returncode == 1
    assert cli(bad, "--rules", "obs-purity").returncode == 0
    assert cli(bad, "--rules", "no-such-rule").returncode == 2
    assert cli(str(tmp_path / "missing")).returncode == 2
    lst = cli("--list-rules")
    assert lst.returncode == 0
    for rid in ("grid-contract", "host-sync", "obs-purity",
                "plan-signature", "predicate-purity"):
        assert rid in lst.stdout and rid in RULES


def test_cli_gates_the_installed_tree_without_torch():
    """``python -m repro_torch.analysis --format json`` with no root lints
    the installed package, exits 0 on it, and imports neither torch nor
    JAX nor the JAX package."""
    code = ("import json, sys\n"
            "for name in ('torch', 'jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            "sys.exit(main(['--format', 'json']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": SRC},
                          timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["root"] == os.path.realpath(PORT_SRC)
    assert doc["findings"] == [] and doc["checked_cuda_files"] >= 4


# ---------------------------------------------------------------------------
# predicate-purity's runtime half and the specs the compiler makes


def _apps():
    from repro_torch.core import (Pattern, make_cf_app, make_fsm_app,
                                  make_mc_app, make_mc_set_app, make_tc_app,
                                  motif_patterns, pattern_app,
                                  pattern_set_app)
    from repro_torch.core.patterns.spec import (PATTERN_SETS,
                                                named_pattern_set,
                                                pattern_names)
    apps = []
    for use_dag in (True, False):
        for eager in (True, False):
            apps.append(make_tc_app(use_dag, eager))
            apps += [make_cf_app(k, use_dag, eager) for k in (3, 4, 5)]
    for k in (3, 4):
        apps.append(make_mc_set_app(k))
        apps += [make_mc_app(k, mode) for mode in ("set", "memo",
                                                   "custom", "generic")]
    apps += [make_fsm_app(3, 2), make_fsm_app(4, 5, max_patterns=32)]
    for name in pattern_names():
        apps += [pattern_app(Pattern.named(name), induced=induced)
                 for induced in (True, False)]
    apps.append(pattern_app(Pattern.from_edges([(0, 1), (1, 2)],
                                               labels=[0, 1, 2])))
    for name in PATTERN_SETS:
        if name != "motifs5":
            apps.append(pattern_set_app(named_pattern_set(name)))
    apps.append(pattern_set_app(motif_patterns(4), induced=False))
    return apps


@pytest.fixture(scope="module")
def apps():
    return _apps()


def test_equal_plan_keys_have_equal_specs(apps):
    from repro_torch.core.plan import plan_app_key
    by_key = {}
    for app in apps:
        by_key.setdefault(plan_app_key(app, "cuda"), []).append(app)
    assert len(by_key) > 20
    for group in by_key.values():
        specs = {repr(app.to_add_spec) for app in group}
        assert len(specs) == 1, [app.name for app in group]


def test_verify_elementwise_accepts_every_spec_kind(apps):
    from repro_torch.analysis.rules.predicate_purity import \
        verify_elementwise
    from repro_torch.core.api import CANONICAL, is_auto_canonical_kernel
    kinds, seen = set(), set()
    for app in apps:
        for i, spec in enumerate(app.to_add_spec or ()):
            k = i + 2
            if (k, repr(spec)) in seen:
                continue
            seen.add((k, repr(spec)))
            out = verify_elementwise(spec, k)
            assert out.dtype.is_floating_point is False and \
                tuple(out.shape) == (8,)
            kinds.add("labeled" if spec.needs_labels else spec.kind)
            if spec.kind == "branches":
                verify_elementwise(spec.bits, k, is_state=True)
    assert kinds == {"clique", "conjunction", "labeled", "branches"}
    verify_elementwise(CANONICAL, 3)
    verify_elementwise(is_auto_canonical_kernel, 4, batch=5)


def test_verify_elementwise_rejects_bad_hooks():
    from repro_torch.analysis.rules.predicate_purity import \
        verify_elementwise

    def shape_bender(emb_cols, u, src_slot, state, conn):
        return u.sum() > 0            # one value, not one per candidate

    with pytest.raises(TypeError, match="not elementwise"):
        verify_elementwise(shape_bender, k=2)

    def brancher(emb_cols, u, src_slot, state, conn):
        if u[0] > 0:                  # a host read of a tensor
            return conn[0]
        return ~conn[0]

    with pytest.raises(TypeError, match="meta tensors"):
        verify_elementwise(brancher, k=2)

    def compactor(emb_cols, u, src_slot, state, conn):
        return conn[0][u > 0]         # a data-dependent size

    with pytest.raises(TypeError, match="meta tensors"):
        verify_elementwise(compactor, k=2)

    def wrong_dtype(emb_cols, u, src_slot, state, conn):
        return u + 1                  # int32, not a keep-mask

    with pytest.raises(TypeError, match="bool keep-mask"):
        verify_elementwise(wrong_dtype, k=2)
    # ... but the same signature is a fine state hook
    verify_elementwise(wrong_dtype, k=2, is_state=True)

    def wide_state(emb_cols, u, src_slot, state, conn):
        return u.long()

    with pytest.raises(TypeError, match="int32 state"):
        verify_elementwise(wide_state, k=2, is_state=True)
