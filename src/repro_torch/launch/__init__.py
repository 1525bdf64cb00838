"""The launcher: meshes, step programs, the dry-run and the RL CLI."""
