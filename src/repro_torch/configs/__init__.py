"""Controller presets of the port (paper Table I, ScenarioLab presets)."""
