"""Host-side file and seeding helpers."""
