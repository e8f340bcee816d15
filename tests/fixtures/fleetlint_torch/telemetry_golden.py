"""fleetlint fixture: the golden sets telemetry_*.py are diffed against
(linted as tests/test_obs.py)."""
FLEET_KEYS = {"admitted"}
DROP_REASONS = {"no_route"}
POOL_KEYS = {"dispatched"}
HIST_KEYS = {"count", "p50"}
SLI_KEYS = {"completed"}
SLI_SCOPES = {"fleet", "by_class", "by_pool"}
ALERT_KEYS = {"firing"}
