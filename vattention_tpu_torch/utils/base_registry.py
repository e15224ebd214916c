"""Generic registry (ref: sarathi-lean/sarathi/utils/base_registry.py:49)."""

from __future__ import annotations

from typing import Any, Dict, Type


class BaseRegistry:
    _registry: Dict[Any, Type] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._registry = {}

    @classmethod
    def register(cls, key, implementation: Type) -> None:
        if key in cls._registry:
            raise ValueError(f"{key!r} already registered")
        cls._registry[key] = implementation

    @classmethod
    def unregister(cls, key) -> None:
        cls._registry.pop(key, None)

    @classmethod
    def get(cls, key, *args, **kwargs):
        if key not in cls._registry:
            raise ValueError(f"{key!r} not registered in {cls.__name__}")
        return cls._registry[key](*args, **kwargs)

    @classmethod
    def get_class(cls, key) -> Type:
        return cls._registry[key]
