"""Sequence status machine (ref: sarathi-lean/sarathi/core/datatypes/sequence_status.py)."""

import enum


class SequenceStatus(enum.Enum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    PAUSED = enum.auto()
    FINISHED_STOPPED = enum.auto()
    FINISHED_LENGTH_CAPPED = enum.auto()
    FINISHED_IGNORED = enum.auto()

    @staticmethod
    def is_finished(status: "SequenceStatus") -> bool:
        return status in (
            SequenceStatus.FINISHED_STOPPED,
            SequenceStatus.FINISHED_LENGTH_CAPPED,
            SequenceStatus.FINISHED_IGNORED,
        )

    @staticmethod
    def is_executing(status: "SequenceStatus") -> bool:
        return status in (SequenceStatus.RUNNING, SequenceStatus.PAUSED)

    @staticmethod
    def is_waiting(status: "SequenceStatus") -> bool:
        return status == SequenceStatus.WAITING

    @staticmethod
    def is_paused(status: "SequenceStatus") -> bool:
        return status == SequenceStatus.PAUSED

    @staticmethod
    def is_running(status: "SequenceStatus") -> bool:
        return status == SequenceStatus.RUNNING

    @staticmethod
    def get_finished_reason(status: "SequenceStatus"):
        if status == SequenceStatus.FINISHED_STOPPED:
            return "stop"
        if status == SequenceStatus.FINISHED_LENGTH_CAPPED:
            return "length"
        if status == SequenceStatus.FINISHED_IGNORED:
            return "length"
        return None
