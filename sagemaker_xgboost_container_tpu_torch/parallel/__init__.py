"""Multi-host training: the cluster lifecycle and the process group."""
