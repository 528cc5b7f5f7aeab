"""Data for the port: image and camera IO, the ray dataset and the synthetic
co-located-flash scenes."""
