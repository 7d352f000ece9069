"""Modules that no run may load: JAX and the JAX package the port was
made from, compared by whole top-level name (openmm_drudenose_tpu_torch,
the port, is not openmm_drudenose_tpu)."""

FORBIDDEN = ("jax", "jaxlib", "flax", "openmm_drudenose_tpu")


def loaded(modules) -> list:
    return sorted({name.split(".")[0] for name in modules}
                  & set(FORBIDDEN))
