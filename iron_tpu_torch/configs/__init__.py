"""Run configurations: `womask_iron.json`, a copy of the JAX package's."""
