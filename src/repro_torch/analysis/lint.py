"""AST lint of the port's hot paths and its C interface.

Port of ``repro.analysis.lint``.  Rules over the ``repro_torch`` sources
(nothing is imported or run):

``host-op``       no ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
                  ``torch.cuda.synchronize`` or host-numpy (``np.``) call
                  in any function reachable from a hot-path root
                  (:data:`HOT_ROOTS`: the model steps, the sampler, the
                  kernels' front doors).  Each is a device-to-host sync
                  (or host work) on every step.  A line may opt out with a
                  ``lint: host-ok`` comment that says why.  The engine's
                  host bookkeeping (numpy page tables, the token
                  read-back) is outside the roots, as in the reference;
                  on the card the ``host`` contract pass names every sync
                  that does happen.
``ctypes-arity``  every ``_SIGNATURES`` entry of ``kernels/build.py`` has
                  as many arguments as its ``extern "C"`` entry point in
                  ``kernels/csrc/*.cu``, every entry point is bound, and
                  every ``launch(kernel, entry, ...)`` /
                  ``geometry(entry, ...)`` call passes that many: a
                  mismatch passes a wrong pointer, on the card only (the
                  role of the reference's ``blockspec-arity``).

``hygiene`` audits the checkout rather than the sources: no tracked
Python bytecode (``git ls-files``).

The reference's ``static-argnames`` and ``jit-in-loop`` rules have no
counterpart: the port has no jit, so there is no trace key to leak into
and no wrapper to rebuild.

Reachability is an over-approximation: module- and function-level
imports both resolve, nested functions are scanned with their parents,
and calls that cannot be resolved (third party, dynamic) are ignored.
"""

from __future__ import annotations

import ast
import re
import subprocess
from dataclasses import dataclass
from pathlib import Path

__all__ = ["LintViolation", "lint_repo", "lint_sources", "ctypes_arity",
           "hygiene_repo", "hygiene_scan", "HOT_ROOTS", "RULES"]

RULES = ("host-op", "ctypes-arity", "hygiene")

# (path suffix, function) of the hot paths' roots
HOT_ROOTS = (
    ("models/transformer.py", "paged_decode_step"),
    ("models/transformer.py", "paged_verify_step"),
    ("models/transformer.py", "paged_prefill"),
    ("models/transformer.py", "prefill"),
    ("models/transformer.py", "decode_step"),
    ("models/transformer.py", "forward"),
    ("serving/sampling.py", "sample_tokens"),
    ("serving/sampling.py", "greedy_tokens"),
    ("serving/sampling.py", "token_logprobs"),
    ("kernels/dispatch.py", "approx_bsn"),
    ("kernels/dispatch.py", "paged_attn_decode"),
    ("kernels/dispatch.py", "paged_attn_verify"),
    ("kernels/dispatch.py", "paged_attn_prefill"),
    ("kernels/dispatch.py", "flash_attention"),
    ("kernels/ops.py", "ternary_matmul"),
)

_HOST_OK_MARK = "lint: host-ok"
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_PKG = "/repro_torch/"


@dataclass(frozen=True)
class LintViolation:
    file: str
    line: int
    rule: str
    message: str

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line, "rule": self.rule,
                "message": self.message}


class _Module:
    def __init__(self, key: str, fname: str, source: str):
        self.key = key
        self.fname = fname
        self.tree = ast.parse(source, filename=fname)
        self.lines = source.splitlines()
        self.functions: dict[str, ast.AST] = {}
        # alias -> ("module", dotted) | ("symbol", dotted_module, name)
        self.imports: dict[str, tuple] = {}
        self._index()

    def _package(self) -> str:
        parts = self.key.split(".")
        return self.key if self.fname.endswith("__init__.py") \
            else ".".join(parts[:-1])

    def _index(self) -> None:
        pkg = self._package()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = \
                        ("module", a.name)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = pkg.split(".")
                    up = up[:len(up) - (node.level - 1)]
                    base = ".".join(up + ([node.module] if node.module
                                          else []))
                for a in node.names:
                    if a.name != "*":
                        self.imports[a.asname or a.name] = \
                            ("symbol", base, a.name)

    def host_ok(self, line: int) -> bool:
        return 1 <= line <= len(self.lines) \
            and _HOST_OK_MARK in self.lines[line - 1]


def _load_modules(files: dict) -> dict:
    """{path: source} -> {dotted key: _Module}; keys from the path, e.g.
    ``.../src/repro_torch/models/moe.py`` -> ``repro_torch.models.moe``."""
    mods = {}
    for fname, src in files.items():
        p = "/" + fname.replace("\\", "/").lstrip("/")
        rel = "repro_torch/" + p.split(_PKG)[-1] if _PKG in p else p[1:]
        key = (rel[:-3] if rel.endswith(".py") else rel).replace("/", ".")
        if key.endswith(".__init__"):
            key = key[:-len(".__init__")]
        mods[key] = _Module(key, fname, src)
    return mods


def _resolve(mods: dict, modkey: str, name: str, depth: int = 0):
    if depth > 8 or modkey not in mods:
        return None
    mod = mods[modkey]
    if name in mod.functions:
        return (modkey, name)
    imp = mod.imports.get(name)
    if imp and imp[0] == "symbol":
        return _resolve(mods, imp[1], imp[2], depth + 1)
    return None


def _call_targets(mods: dict, mod: _Module, fn: ast.AST) -> list:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        tgt = None
        if isinstance(f, ast.Name):
            tgt = _resolve(mods, mod.key, f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            base = f.value.id
            imp = mod.imports.get(base)
            if base == "self":
                tgt = _resolve(mods, mod.key, f.attr)
            elif imp and imp[0] == "module":
                tgt = _resolve(mods, imp[1], f.attr)
            elif imp and imp[0] == "symbol":
                # "from ..kernels import dispatch": a module as a symbol
                tgt = _resolve(mods, f"{imp[1]}.{imp[2]}", f.attr)
        if tgt:
            out.append(tgt)
    return out


def _reachable(mods: dict, roots) -> tuple[set, list]:
    """(reached (modkey, function) set, stale-root violations)."""
    stale, frontier = [], []
    for suffix, fname in roots:
        hit = [m for m in mods.values()
               if m.fname.replace("\\", "/").endswith(suffix)]
        if not hit or fname not in hit[0].functions:
            stale.append(LintViolation(
                suffix, 0, "host-op",
                f"hot-path root {suffix}:{fname} not found: update "
                "analysis/lint.HOT_ROOTS"))
            continue
        frontier.append((hit[0].key, fname))
    seen: set = set()
    while frontier:
        node = frontier.pop()
        if node in seen or node[0] not in mods:
            continue
        seen.add(node)
        mod = mods[node[0]]
        fn = mod.functions.get(node[1])
        if fn is not None:
            frontier.extend(_call_targets(mods, mod, fn))
    return seen, stale


def _numpy_aliases(mod: _Module) -> set:
    return {alias for alias, imp in mod.imports.items()
            if imp == ("module", "numpy")
            or (imp[0] == "symbol" and imp[1] == "numpy")}


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _host_op_scan(mods: dict, reached) -> list:
    vios = []
    for modkey, fname in sorted(reached):
        mod = mods[modkey]
        fn = mod.functions.get(fname)
        np_names = _numpy_aliases(mod)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or mod.host_ok(node.lineno):
                continue
            f = node.func
            what = None
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and not node.args and not node.keywords:
                what = f".{f.attr}() copies to the host and waits"
            elif _dotted(f) == "torch.cuda.synchronize":
                what = "torch.cuda.synchronize() waits for the card"
            elif isinstance(f, ast.Attribute) \
                    and _dotted(f).split(".")[0] in np_names:
                what = f"host numpy ({_dotted(f)}) runs on the host"
            if what:
                vios.append(LintViolation(
                    mod.fname, node.lineno, "host-op",
                    f"{fname}: {what}, in code a hot-path root reaches"))
    return vios


# ---------------------------------------------------------------------------
# ctypes-arity
# ---------------------------------------------------------------------------

_EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                     re.S)


def c_entry_points(sources: dict[str, str]) -> dict[str, tuple[str, int]]:
    """{entry point: (file, parameter count)} of the ``extern "C"``
    functions in CUDA sources {file: text}."""
    out = {}
    for fname, text in sources.items():
        for m in _EXTERN.finditer(text):
            params = m.group(2).strip()
            n = 0 if params in ("", "void") else params.count(",") + 1
            out[m.group(1)] = (fname, n)
    return out


def _list_len(node: ast.AST) -> int | None:
    """Length of a list expression built from literals, ``+`` and
    ``* <int>``."""
    if isinstance(node, ast.List):
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _list_len(node.left), _list_len(node.right)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, k in ((node.left, node.right), (node.right, node.left)):
            if isinstance(k, ast.Constant) and isinstance(k.value, int):
                n = _list_len(lst)
                return None if n is None else n * k.value
    return None


def python_signatures(build_src: str) -> dict[str, tuple[int, int | None]]:
    """{entry point: (line, argument count)} bound by ``kernels/build.py``:
    its ``_SIGNATURES`` dict and any ``lib.<name>.argtypes = [...]``."""
    out = {}
    for node in ast.walk(ast.parse(build_src)):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "_SIGNATURES" \
                        and isinstance(node.value, ast.Dict):
                    for k, v in zip(node.value.keys, node.value.values):
                        if isinstance(k, ast.Constant):
                            out[k.value] = (k.lineno, _list_len(v))
                elif isinstance(t, ast.Attribute) and t.attr == "argtypes" \
                        and isinstance(t.value, ast.Attribute):
                    out[t.value.attr] = (node.lineno, _list_len(node.value))
    return out


def _call_arities(mod: _Module) -> list[tuple[int, str, int]]:
    """(line, entry point, C arguments passed) of every ``launch(kernel,
    entry, ...)`` and ``geometry(entry, ...)`` call with a literal entry
    point and no ``*args``."""
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) \
                or any(isinstance(a, ast.Starred) for a in node.args):
            continue
        name = _dotted(node.func).split(".")[-1]
        if name == "launch" and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            out.append((node.lineno, node.args[1].value,
                        len(node.args) - 2))
        elif name == "geometry" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and node.args[0].value.endswith("_geometry"):
            # geometry() appends the output array
            out.append((node.lineno, node.args[0].value, len(node.args)))
    return out


def ctypes_arity(build_src: str, cuda_sources: dict[str, str],
                 modules: dict | None = None,
                 build_name: str = "kernels/build.py") -> list:
    """The ``ctypes-arity`` rule over ``kernels/build.py``'s source, the
    CUDA sources and (optionally) the loaded modules' launch calls."""
    vios = []
    c = c_entry_points(cuda_sources)
    py = python_signatures(build_src)
    for name, (line, n) in sorted(py.items()):
        if name not in c:
            vios.append(LintViolation(
                build_name, line, "ctypes-arity",
                f"{name} is bound but no csrc source has it as an "
                'extern "C" entry point'))
        elif n is not None and n != c[name][1]:
            vios.append(LintViolation(
                build_name, line, "ctypes-arity",
                f"{name}: {n} argtypes for the {c[name][1]} parameters of "
                f"its extern \"C\" entry point in {c[name][0]}"))
    for name, (fname, _) in sorted(c.items()):
        if name not in py:
            vios.append(LintViolation(
                fname, 0, "ctypes-arity",
                f'extern "C" {name} has no argtypes in {build_name}'))
    for mod in (modules or {}).values():
        for line, entry, n in _call_arities(mod):
            if entry in c and n != c[entry][1]:
                vios.append(LintViolation(
                    mod.fname, line, "ctypes-arity",
                    f"call passes {n} arguments to {entry}, whose extern "
                    f'"C" entry point takes {c[entry][1]}'))
    return vios


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_sources(files: dict, roots=(), cuda_sources: dict | None = None
                 ) -> list:
    """Lint a {path: source} mapping: ``host-op`` from ``roots`` and, with
    ``cuda_sources`` ({file: text}) and a ``kernels/build.py`` among the
    files, ``ctypes-arity``."""
    mods = _load_modules(files)
    vios = []
    if roots:
        reached, stale = _reachable(mods, roots)
        vios += stale + _host_op_scan(mods, reached)
    if cuda_sources is not None:
        build = [m for m in mods.values()
                 if m.fname.replace("\\", "/").endswith("kernels/build.py")]
        if build:
            vios += ctypes_arity("\n".join(build[0].lines), cuda_sources,
                                 mods, build[0].fname)
    return sorted(vios, key=lambda v: (v.file, v.line, v.rule))


def hygiene_scan(tracked_paths) -> list:
    """Tracked-bytecode paths among repo-relative paths."""
    return [LintViolation(f, 0, "hygiene",
                          "tracked Python bytecode: `git rm --cached` it "
                          "(.gitignore keeps __pycache__/ and *.pyc out)")
            for f in (p.replace("\\", "/") for p in tracked_paths)
            if f.endswith(".pyc") or "__pycache__/" in f]


def hygiene_repo(repo_root: Path | str | None = None) -> list:
    """The hygiene rule over the git index (nothing outside a checkout)."""
    if repo_root is None:
        repo_root = Path(__file__).resolve().parents[3]
    try:
        out = subprocess.run(["git", "ls-files"], cwd=str(repo_root),
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return []
    return hygiene_scan(out.stdout.splitlines())


def lint_repo(src_root: Path | str | None = None, roots=HOT_ROOTS) -> list:
    """``host-op`` and ``ctypes-arity`` over ``repro_torch/**/*.py`` and
    ``kernels/csrc/*.cu`` under ``src_root`` (default: this package)."""
    src_root = Path(src_root) if src_root is not None \
        else Path(__file__).resolve().parent.parent
    files = {str(p.relative_to(src_root.parent)): p.read_text(
        encoding="utf-8") for p in sorted(src_root.rglob("*.py"))}
    cuda = {p.name: p.read_text(encoding="utf-8")
            for p in sorted((src_root / "kernels" / "csrc").glob("*.cu"))}
    return lint_sources(files, roots=roots, cuda_sources=cuda)
