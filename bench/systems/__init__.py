"""Systems under test, found by the configuration's ``system``."""
