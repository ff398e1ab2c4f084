"""The harness of the gs2pc_torch benchmark (see run.py one level up)."""
