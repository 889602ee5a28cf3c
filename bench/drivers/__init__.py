"""Drivers of load, one a traffic kind, found by a traffic file's
``driver``."""
