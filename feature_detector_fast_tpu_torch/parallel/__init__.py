"""Multi-device front-end: a single controller over explicit device lists."""
