"""The engine's span records and request timeline, copied from the JAX
package's ``obs`` (``spans``, ``timeline``); its exporters, sampler and
attribution are not ported."""
