"""Grid data model: bus systems, MATPOWER cases, synthetic meshes."""
