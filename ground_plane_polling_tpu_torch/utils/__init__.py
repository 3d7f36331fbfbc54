"""Host-side output formatting."""
