"""Test-support utilities of the port (importable without torch work)."""
