"""Singleton metaclass (ref: sarathi-lean/sarathi/utils/singleton.py:13)."""

from __future__ import annotations


class Singleton(type):
    _instances = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]

    @classmethod
    def reset(mcs, cls=None):
        if cls is None:
            mcs._instances.clear()
        else:
            mcs._instances.pop(cls, None)
