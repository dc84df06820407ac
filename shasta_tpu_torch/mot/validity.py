"""Track state-string validity logic: the port of shasta_tpu/mot/validity.py.

Behavioral reference: mot_3d/data_protos/validity.py — parses the
'state_mode_age' strings produced by HitManager.state_string to decide
which tracks are output-worthy.
"""
from __future__ import annotations


class Validity:
    TYPES = ("birth", "alive", "dead")

    @classmethod
    def valid(cls, state_string: str) -> bool:
        tokens = state_string.split("_")
        if tokens[0] == "birth":
            return True
        if len(tokens) < 3:
            return False
        return tokens[0] == "alive" and int(tokens[1]) == 1

    @classmethod
    def notoutput(cls, state_string: str) -> bool:
        tokens = state_string.split("_")
        if len(tokens) < 3:
            return False
        return tokens[0] == "alive" and int(tokens[1]) != 1

    @classmethod
    def agein2hz(cls, state_string: str) -> int:
        tokens = state_string.split("_")
        return int(tokens[-1])
