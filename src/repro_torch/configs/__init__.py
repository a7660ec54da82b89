"""The arch registry (``ARCHS``, ``get_arch``), the workload registry and
the engine constructors (``configs.base``).

``ARCHS`` and ``get_arch`` load on first use: the arch files import
``configs.base``, which imports the serving stack."""


def __getattr__(name: str):
    if name in ("ARCHS", "get_arch"):
        from repro_torch.configs import registry

        return getattr(registry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
