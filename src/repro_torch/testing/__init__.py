"""Test support: the scripted, clock-free fault harness (``faults``)."""
