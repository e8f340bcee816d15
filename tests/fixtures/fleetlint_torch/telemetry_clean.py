"""fleetlint fixture: snapshot writers in lockstep with telemetry_golden.py
(linted as both router/telemetry.py and obs/slo.py)."""


class Histogram:
    def summary(self):
        return {"count": 0, "p50": 0.0}


class PoolCounters:
    def summary(self):
        return {"dispatched": 0}


class Telemetry:
    def __init__(self):
        self.drops_by_reason = {"no_route": 0}

    def snapshot(self):
        return {"admitted": 0}


class SLIScope:
    def summary(self):
        return {"completed": 0}


class SLIRegistry:
    def summary(self):
        return {"fleet": {}, "by_class": {}, "by_pool": {}}


class AlertBus:
    def snapshot(self):
        return {"firing": []}
