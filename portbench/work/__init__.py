"""Operation and byte counts, from the shapes and valid lengths of the
work a call does (never from the kernel that does it)."""
