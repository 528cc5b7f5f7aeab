"""Data for the port: the synthetic co-located-flash scenes."""
