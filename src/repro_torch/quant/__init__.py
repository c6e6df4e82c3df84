"""The int8 path: kernel K2 and the int8 arena executors."""
