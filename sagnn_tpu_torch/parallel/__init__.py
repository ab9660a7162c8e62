"""Meshes of torch devices and the ring backend's edge-partitioned SpMM."""
