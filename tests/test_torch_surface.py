"""The port's public surface against the reference's.

Every module of ``src/repro/`` with an ``__all__`` -- read with ``ast``,
so that no reference module (and no JAX) is imported -- has each of its
names in the port's module of the same path (``repro/x/y.py`` ->
``repro_torch.x.y``), or in :data:`LEFT_OUT` with the reason and, where
there is one, the port's counterpart.  The front doors' and the
dispatchers' parameters are held the same way against
:data:`LEFT_OUT_KEYWORDS`.  A reference name with no counterpart fails
here until the port has it or the exception says why not.
"""
import ast
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
REFERENCE = ROOT / "repro"

# The backend switch of the reference: the port's dispatch is decided
# by the operand's device (a CUDA tensor launches the kernel, a CPU
# tensor runs its plain version), with no switch and no fallback.
_NO_SWITCH = ("the port has no backend switch: the operand's device "
              "decides (ROADMAP ground rules, Dispatch)")

_SAME_COUNT = ("the port dispatches on every call (it compiles nothing), "
               "so its dispatch counter counts the executions")
_TRACES = "repro_torch.kernels.ops.DISPATCH_COUNTS"

# name -> (reason, the port's counterpart as a dotted path, or None)
LEFT_OUT = {
    "BACKENDS": (_NO_SWITCH, None),
    "DEFAULT_BACKEND": (_NO_SWITCH, None),
    "INTERPRET": ("Pallas interpret mode; CUDA kernels have none, a CPU "
                  "tensor runs the plain version", None),
    "resolve_backend": (_NO_SWITCH, None),
    "VmapSubstrate": ("jax.vmap over t virtual machines",
                      "repro_torch.cluster.BatchedSubstrate"),
    "ShardMapSubstrate": ("shard_map over a jax Mesh",
                          "repro_torch.cluster.ProcessGroupSubstrate"),
    "shard_map": ("a jax transform; the bodies run on a rank's rows",
                  "repro_torch.cluster.ProcessGroupSubstrate.run"),
    "HAS_RAGGED": ("a jax version probe; torch's all_to_all_single takes "
                   "split sizes in every version",
                   "repro_torch.cluster.compat.ragged_all_to_all"),
    "DONATION_PLATFORMS": ("jit buffer donation; the port's optimizer and "
                           "exchange write in place, nothing is donated",
                           None),
    "boundaries_jax": ("the reference's name for its jnp Algorithm 1",
                       "repro_torch.core.boundaries.boundaries"),
    # the reference's opt-in lenses: a per-execution counter and per-op
    # host time (a synchronize a call)
    "EXEC_COUNTS_ENABLED": (_SAME_COUNT, _TRACES),
    "enable_exec_counts": (_SAME_COUNT, _TRACES),
    "exec_dispatch_counts": (_SAME_COUNT, _TRACES),
    "OP_TIMING_ENABLED": ("host time with a synchronize a call, which "
                          "changes what it times; an op's device time is "
                          "read from the profiler under the obs.trace "
                          "spans around it", "repro_torch.obs.trace.span"),
}

# The JAX-only keywords of the checked functions.
LEFT_OUT_KEYWORDS = {
    "kernel_backend": (_NO_SWITCH, None),
    "backend": (_NO_SWITCH + " (the ops' backend= is the switch)", None),
    "donate": ("jit buffer donation", None),
    "scan_unroll": ("lax.scan's unroll: the port loops in Python", None),
    "block_rows": ("a Pallas grid block: each CUDA kernel sizes its own "
                   "tiles", None),
    "block_n": ("a Pallas grid block", None),
    "block_q": ("a Pallas grid block", None),
    "block_k": ("a Pallas grid block", None),
}

# (reference file under src/repro, functions) whose parameters the port
# keeps: the front doors, the step builders and the kernel dispatchers
KEYWORD_FUNCTIONS = {
    "cluster/api.py": ("sort", "join", "moe_dispatch"),
    "serve/engine.py": ("generate",),
    "launch/train.py": ("train",),
    "launch/steps.py": ("build_train_step", "build_prefill_step",
                        "build_decode_step", "build_step"),
    "kernels/ops.py": ("sort", "sort_kv", "searchsorted", "sort_partition",
                       "sort_partition_kv", "bucketize_histogram",
                       "merge_sorted_rows", "merge_sorted_rows_kv",
                       "flash_attention"),
}


def _reference_all(path: pathlib.Path):
    for node in ast.parse(path.read_text()).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "__all__"
               for t in targets):
            return list(ast.literal_eval(node.value))
    return None


def _port_module(path: pathlib.Path) -> str:
    parts = list(path.relative_to(REFERENCE).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch"] + parts)


MODULES = sorted(str(p.relative_to(REFERENCE))
                 for p in REFERENCE.rglob("*.py")
                 if _reference_all(p) is not None)


def _missing(rel: str):
    path = REFERENCE / rel
    port = importlib.import_module(_port_module(path))
    return [n for n in _reference_all(path) if not hasattr(port, n)]


def _resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def test_the_reference_has_modules_with_a_public_list():
    assert len(MODULES) > 40 and "cluster/api.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_every_reference_name_has_a_counterpart(rel):
    for name in _missing(rel):
        assert name in LEFT_OUT, (
            f"repro/{rel} exports {name!r}; the port's "
            f"{_port_module(REFERENCE / rel)} has no such name and "
            f"LEFT_OUT gives no reason")


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_each_left_out_name_is_missing_and_has_its_counterpart(name):
    reason, counterpart = LEFT_OUT[name]
    assert reason
    assert any(name in _missing(rel) for rel in MODULES), (
        f"{name!r} is in LEFT_OUT but no port module lacks it")
    if counterpart is not None:
        _resolve(counterpart)


def _reference_params(rel: str, fn: str):
    for node in ast.parse((REFERENCE / rel).read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            a = node.args
            return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    raise LookupError(f"repro/{rel} has no function {fn}")


CHECKED = [(rel, fn) for rel, fns in KEYWORD_FUNCTIONS.items()
           for fn in fns]


def _missing_params(rel: str, fn: str):
    module = importlib.import_module(_port_module(REFERENCE / rel))
    port = inspect.signature(getattr(module, fn)).parameters
    return [p for p in _reference_params(rel, fn) if p not in port]


@pytest.mark.parametrize("rel,fn", CHECKED)
def test_every_reference_parameter_has_a_counterpart(rel, fn):
    for param in _missing_params(rel, fn):
        assert param in LEFT_OUT_KEYWORDS, (
            f"repro/{rel}:{fn} takes {param!r}; the port's does not and "
            f"LEFT_OUT_KEYWORDS gives no reason")


@pytest.mark.parametrize("param", sorted(LEFT_OUT_KEYWORDS))
def test_each_left_out_keyword_is_missing(param):
    assert LEFT_OUT_KEYWORDS[param][0]
    assert any(param in _missing_params(rel, fn) for rel, fn in CHECKED), (
        f"{param!r} is in LEFT_OUT_KEYWORDS but every checked function "
        f"of the port takes it")
