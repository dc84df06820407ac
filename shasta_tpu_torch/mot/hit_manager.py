"""Track life-cycle FSM: birth -> alive -> dead; the port of
shasta_tpu/mot/hit_manager.py.

Behavioral reference: mot_3d/life/hit_manager.py:14-96. States and
transitions preserved exactly, including: instant 'alive' when the track is
born within the first min_hits frames; hit_streak reset on a missed
key-frame prediction; death after max_age frames without update.
"""
from __future__ import annotations


class HitManager:
    def __init__(self, configs: dict, frame_index: int):
        self.time_since_update = 0
        self.hits = 1
        self.hit_streak = 1
        self.first_continuing_hit = 1
        self.still_first = True
        self.age = 0

        self.max_age = configs["running"]["max_age_since_update"]
        self.min_hits = configs["running"]["min_hits_to_birth"]

        self.state = "birth"
        self.recent_state = 1
        self.no_asso = False
        if frame_index <= self.min_hits or self.min_hits == 0:
            self.state = "alive"

    def predict(self, is_key_frame: bool = True):
        if not is_key_frame:
            return
        self.age += 1
        if self.time_since_update > 0:
            self.hit_streak = 0
            self.still_first = False
        self.time_since_update += 1

    def update(self, mode: int, frame_index: int, is_key_frame: bool = True):
        self.recent_state = mode
        if mode != 0:
            self.time_since_update = 0
            self.hits += 1
            self.hit_streak += 1
            if self.still_first:
                self.first_continuing_hit += 1
        if is_key_frame:
            self._transition(mode, frame_index)

    def _transition(self, mode: int, frame_index: int):
        if self.state == "birth":
            if self.hits >= self.min_hits or frame_index <= self.min_hits:
                self.state = "alive"
                self.recent_state = mode
            elif self.time_since_update >= self.max_age:
                self.state = "dead"
        elif self.state == "alive":
            if self.time_since_update >= self.max_age:
                self.state = "dead"

    def alive(self, frame_index: int) -> bool:
        return self.state == "alive"

    def death(self, frame_index: int) -> bool:
        return self.state == "dead"

    def valid_output(self, frame_index: int) -> bool:
        return self.state == "alive" and not self.no_asso

    def state_string(self, frame_index: int) -> str:
        if self.state == "birth":
            return f"birth_{self.hits}"
        if self.state == "alive":
            return f"alive_{self.recent_state}_{self.time_since_update}"
        return f"dead_{self.time_since_update}"
