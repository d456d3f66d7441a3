"""Public-name parity between `singa_tpu` and the port, module by module.

For each module of `singa_tpu` that has a counterpart in
`singa_tpu_torch` (the same relative path), the JAX file is parsed with
`ast` (nothing of it is imported), and every public top-level function
and class, and every public alias of one (`create_cuda_gpu =
create_tpu_device`), must resolve on the port's module; for the classes
in CLASSES every public method (the class's own and those of its bases in
the same file) must resolve on the port's class.

A name that waits for a later slice of the port is listed in PENDING,
by module, with the ROADMAP.md Queue 1 item that brings it (7: the
remaining operations layers; item 6, multi-replica serving with its A/B
command lines, and item 7a, `capacity` and `audit`, are ported and
checked here). A listed
name that resolves fails the test: the list only shrinks, except when a
module is ported in part (`introspect` without the warm store, `diag`
without /profilez), which adds that module's unported names.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "singa_tpu")
PORT_PKG = os.path.join(ROOT, "singa_tpu_torch")

#: {module: {name or "Class.method": Queue 1 item that ports it}}
PENDING = {
    "device": {"Device.StartTrace": 7, "Device.StopTrace": 7},
    "diag": {"DiagServer.retain_trace_dir": 7},
    "introspect": {"export_executable": 7, "load_executable": 7},
    "model": {"Model.lower_step": 7, "Model.step_cost_analysis": 7},
    "overlap": {"async_available": 7, "overlap_report": 7},
}

#: (module, class) whose public methods must resolve
CLASSES = {
    "tensor": ("Tensor",), "layer": ("Layer",), "model": ("Model",),
    "device": ("Device",), "opt": ("Optimizer", "SGD", "Adam", "DistOpt"),
    "parallel.communicator": ("Communicator",),
    "engine": ("ServingEngine", "EngineRequest"),
    "health": ("HealthMonitor", "StepStatsCollector", "FlightRecorder"),
    "resilience": ("FaultPlan", "TrainController"),
    "introspect": ("AotExecutor",),
    "slo": ("SLOConfig", "SLOTracker", "TailCollector"),
    "watchdog": ("Watchdog", "OpDeadline"),
    "memory": ("MemoryLedger", "LeakDetector"),
    "goodput": ("GoodputTracker",),
    "models.transformer": ("PipelinedGPT",),
    "diag": ("DiagServer",),
    "fleet": ("ShardWriter", "FleetAggregator"),
    "router": ("Router", "ReplicaControl"),
    "capacity": ("CapacityModel", "DemandForecaster", "ShadowScaler"),
    "audit": ("ParamFingerprinter", "CanaryProber", "ShadowReplayer",
              "AuditObservatory"),
}


def _modules():
    """Dotted names of the JAX modules with a port counterpart (a package
    as `<package>.__init__`)."""
    out = []
    for root, _, files in os.walk(PORT_PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), PORT_PKG)
            if not os.path.exists(os.path.join(JAX_PKG, rel)):
                continue
            out.append(rel[:-3].replace(os.sep, "."))
    return sorted(out)


def _public_names(tree, package=False):
    """Public top-level functions, classes and their aliases; in a
    package's `__init__`, also the public names it re-exports from its
    own modules (`from .mesh import make_mesh`)."""
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}
    names = [n for n in defs if not n.startswith("_")]
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                and node.value.id in defs:
            names += [t.id for t in node.targets if isinstance(t, ast.Name)
                      and not t.id.startswith("_")]
        elif package and isinstance(node, ast.ImportFrom) \
                and node.level == 1 and node.module:
            names += [a.asname or a.name for a in node.names
                      if not (a.asname or a.name).startswith("_")]
    return names, defs


def _methods(cls, defs):
    """Public methods of `cls` and of its bases defined in the same file
    (class-level aliases included)."""
    out, seen, todo = [], set(), [cls]
    while todo:
        node = defs.get(todo.pop())
        if node is None or node.name in seen:
            continue
        seen.add(node.name)
        for b in node.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and not b.name.startswith("_"):
                out.append(b.name)
            elif isinstance(b, ast.Assign) and isinstance(b.value, ast.Name):
                out += [t.id for t in b.targets if isinstance(t, ast.Name)
                        and not t.id.startswith("_")]
        todo += [ast.unparse(base) for base in node.bases]
    return out


MODULES = _modules()


def test_the_sweep_covers_the_ported_modules():
    assert {"tensor", "autograd", "layer", "model", "opt", "device",
            "serving", "engine", "observe", "config", "channel",
            "image_tool", "ops.attention", "models.transformer", "slo",
            "health", "resilience", "watchdog", "memory", "goodput",
            "introspect", "distributed", "parallel.mesh",
            "parallel.communicator", "parallel.__init__", "parallel.tp",
            "parallel.pipeline", "sonnx.backend", "__init__",
            "models.__init__"} <= set(MODULES)
    assert set(PENDING) <= set(MODULES)
    assert all(item in (2, 3, 4, 5, 6, 7)
               for names in PENDING.values() for item in names.values())


@pytest.mark.parametrize("name", MODULES)
def test_public_names_resolve_on_the_port(name):
    with open(os.path.join(JAX_PKG, name.replace(".", os.sep) + ".py")) \
            as f:
        tree = ast.parse(f.read())
    port = importlib.import_module(
        "singa_tpu_torch." + name.removesuffix("__init__").rstrip(".")
        if name != "__init__" else "singa_tpu_torch")
    names, defs = _public_names(tree, name.endswith("__init__"))
    pending = PENDING.get(name, {})
    missing, early = [], []
    wanted = [(n, getattr(port, n, None)) for n in names]
    for cls in CLASSES.get(name, ()):
        pcls = getattr(port, cls)
        wanted += [(f"{cls}.{m}", getattr(pcls, m, None))
                   for m in _methods(cls, defs)]
    for key, got in wanted:
        if key in pending:
            if got is not None:
                early.append(key)
        elif got is None:
            missing.append(key)
    listed = {k for k, _ in wanted}
    stale = sorted(set(pending) - listed)
    assert not missing, f"{name}: JAX names missing on the port: {missing}"
    assert not early, (f"{name}: {early} resolve on the port now; take "
                       "them out of PENDING")
    assert not stale, f"{name}: PENDING names JAX does not have: {stale}"


#: (module, "Class.method") whose positional parameters must be the JAX
#: package's, in its order (the port may append its own after them, as
#: the GPT's `device` and `seed`), with every JAX keyword-only parameter
SIGNATURES = [("layer", "Embedding.__init__"), ("layer", "Linear.__init__"),
              ("models.transformer", "GPT.__init__"),
              ("models.transformer", "PipelinedGPT.__init__"),
              ("model", "Model.compile")]


def _jax_params(module, path):
    with open(os.path.join(JAX_PKG, module.replace(".", os.sep) + ".py")) \
            as f:
        tree = ast.parse(f.read())
    cls, meth = path.split(".")
    node = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    fn = next(n for n in node.body
              if isinstance(n, ast.FunctionDef) and n.name == meth)
    a = fn.args
    return ([x.arg for x in a.posonlyargs + a.args], a.vararg is not None,
            [x.arg for x in a.kwonlyargs])


@pytest.mark.parametrize("module,path", SIGNATURES)
def test_positional_parameters_match_jax(module, path):
    import inspect
    pos, vararg, kwonly = _jax_params(module, path)
    cls, meth = path.split(".")
    fn = getattr(getattr(importlib.import_module(
        "singa_tpu_torch." + module), cls), meth)
    params = list(inspect.signature(fn).parameters.values())
    got = [p.name for p in params if p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    assert got[:len(pos)] == pos, (path, got, pos)
    assert vararg == any(p.kind == p.VAR_POSITIONAL for p in params)
    assert set(kwonly) <= {p.name for p in params
                           if p.kind == p.KEYWORD_ONLY}, path
