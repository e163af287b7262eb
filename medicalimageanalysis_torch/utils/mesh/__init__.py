"""Triangle meshes: the TriMesh container, smoothing and decimation."""
