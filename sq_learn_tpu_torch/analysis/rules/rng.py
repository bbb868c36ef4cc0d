"""Rule ``rng-discipline`` — no draw from a global RNG (counterpart of
``sq_learn_tpu/analysis/rules/rng.py``, for torch).

Every stochastic routine of the port draws from an explicit
``torch.Generator`` or a seeded NumPy generator. Flags, outside the
``utils/random.py`` / ``utils/validation.py`` allowlist:

- a torch draw without ``generator=``: ``torch.rand*``, ``randn*``,
  ``randint*``, ``randperm``, ``multinomial``, ``normal``,
  ``bernoulli``, ``binomial``, ``poisson``, and the in-place tensor
  draws (``uniform_``, ``normal_``, ``exponential_``, …) — each draws
  from torch's default generator of its device;
- a write of torch's global seed (``torch.manual_seed``,
  ``torch.cuda.manual_seed``, ``manual_seed_all``, ``torch.seed``),
  which reseeds every unseeded draw in the process;
- calls into the global NumPy/stdlib RNG state (``np.random.<draw>``,
  ``random.<draw>``, unseeded ``default_rng()``/``RandomState()``), as
  in the JAX package.

The JAX rule's check of ``jax.random.PRNGKey(<literal>)`` has no
object here: a ``torch.Generator`` is seeded by its caller.
"""

import ast
import os

from ..core import Finding, Rule, dotted_name, import_aliases

#: files allowed to touch the global RNG machinery (they manage it)
ALLOWLIST = ("utils/random.py", "utils/validation.py")

#: numpy.random constructors that are fine WHEN SEEDED
_SEEDED_OK = {"default_rng", "RandomState", "Generator", "SeedSequence",
              "PCG64", "Philox", "MT19937", "SFC64", "BitGenerator"}

#: stdlib ``random`` draws off the module-global state
_STDLIB_DRAWS = {"random", "seed", "randint", "randrange", "choice",
                 "choices", "shuffle", "sample", "uniform", "gauss",
                 "normalvariate", "betavariate", "expovariate",
                 "getrandbits", "triangular"}

#: ``torch.<name>`` draws that take ``generator=``
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "multinomial", "normal",
                "bernoulli", "binomial", "poisson"}

#: in-place tensor draws (``t.<name>(..., generator=g)``); numpy has no
#: method of these names, so any receiver counts
_INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "bernoulli_",
                  "cauchy_", "geometric_", "log_normal_", "random_"}

#: writes of torch's process-global seed
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",
                 "torch.random.manual_seed", "torch.random.seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "torch.cuda.seed", "torch.cuda.seed_all"}


def _is_allowlisted(relpath):
    rp = relpath.replace(os.sep, "/")
    return any(rp.endswith(a) for a in ALLOWLIST)


def _has_generator(node):
    return any(kw.arg == "generator" for kw in node.keywords)


class RngDisciplineRule(Rule):
    name = "rng-discipline"
    description = ("no global torch/numpy/stdlib RNG outside "
                   "utils/random.py & utils/validation.py: torch draws "
                   "take generator=, no torch.manual_seed")

    def check_module(self, ctx, tree, relpath, source):
        if _is_allowlisted(relpath):
            return ()
        aliases = import_aliases(tree)
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                findings.extend(self._torch_rng(node, relpath, aliases))
                findings.extend(self._global_rng(node, relpath, aliases))
        return findings

    def _torch_rng(self, node, relpath, aliases):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_DRAWS
                and not _has_generator(node)):
            yield Finding(
                self.name, relpath, node.lineno,
                f".{node.func.attr}(...) draws from torch's default "
                f"generator — pass generator=")
            return
        fn = dotted_name(node.func)
        if not fn:
            return
        parts = fn.split(".")
        resolved = ".".join([aliases.get(parts[0], parts[0])] + parts[1:])
        if resolved in _GLOBAL_SEEDS:
            yield Finding(
                self.name, relpath, node.lineno,
                f"{resolved}(...) touches torch's global seed — seed a "
                f"torch.Generator instead")
        elif (resolved.startswith("torch.")
              and resolved[len("torch."):] in _TORCH_DRAWS
              and not _has_generator(node)):
            yield Finding(
                self.name, relpath, node.lineno,
                f"{resolved}(...) draws from torch's default generator "
                f"— pass generator=")

    def _global_rng(self, node, relpath, aliases):
        fn = dotted_name(node.func)
        if not fn:
            return
        parts = fn.split(".")
        root = aliases.get(parts[0], parts[0])
        resolved = ".".join([root] + parts[1:])
        if resolved.startswith("numpy.random."):
            tail = resolved[len("numpy.random."):]
            if tail in _SEEDED_OK:
                if not node.args and not node.keywords:
                    yield Finding(
                        self.name, relpath, node.lineno,
                        f"unseeded np.random.{tail}() draws entropy "
                        f"from the OS — pass an explicit seed")
            elif "." not in tail:
                yield Finding(
                    self.name, relpath, node.lineno,
                    f"np.random.{tail}(...) uses the module-global RNG "
                    f"— thread a seeded Generator")
        elif resolved.startswith("numpy.random.mtrand"):
            yield Finding(
                self.name, relpath, node.lineno,
                "numpy.random.mtrand global state outside the "
                "validation allowlist")
        elif root == "random" and len(parts) == 2:
            if parts[1] in _STDLIB_DRAWS:
                yield Finding(
                    self.name, relpath, node.lineno,
                    f"random.{parts[1]}(...) uses the stdlib global "
                    f"RNG — thread explicit randomness")
            elif parts[1] == "Random" and not node.args:
                yield Finding(
                    self.name, relpath, node.lineno,
                    "unseeded random.Random() — pass an explicit seed")
