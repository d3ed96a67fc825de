"""Helpers of the port's tests that compute a JAX reference once."""

import jax
import jax.numpy as jnp
import numpy as np

# a reference program runs once: its compile time is all it costs
CHEAP_XLA = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}


def per_window(fn, batched_args, n):
    """``jax.vmap(fn)(*batched_args)`` over the first ``n`` windows, the
    cheap way for a reference: ``fn`` is compiled unbatched (faster to
    trace than the vmapped program) with XLA's cheap CPU backend options,
    run per window, and the results are stacked."""
    one = lambda b: jax.tree.map(lambda x: x[b], batched_args)
    run = jax.jit(fn).lower(*one(0)).compile(compiler_options=CHEAP_XLA)
    return jax.tree.map(lambda *x: jnp.stack(x),
                        *[run(*one(b)) for b in range(n)])


def to_numpy(x):
    """A JAX pytree of NamedTuples as nested dicts of numpy arrays (the
    input of the port's ``tree_from_numpy``)."""
    if hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def cheap_jit(fn, static_argnums=()):
    """``jax.jit(fn)`` compiled with the cheap options above, once per
    signature of its arguments (tree structure, shapes, dtypes and the
    static arguments' values): for a reference called eagerly, where
    dispatching op by op costs more than one cheap compile."""
    jitted = jax.jit(fn, static_argnums=static_argnums)
    cache = {}

    def call(*args):
        dyn = [a for i, a in enumerate(args) if i not in static_argnums]
        leaves, tree = jax.tree.flatten(dyn)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves),
               tuple(args[i] for i in static_argnums))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(
                compiler_options=CHEAP_XLA)
        return cache[key](*dyn)
    return call
