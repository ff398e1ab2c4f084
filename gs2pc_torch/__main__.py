from gs2pc_torch.cli import main

# Guarded: the ranks of a multi-device sweep are spawned processes, which
# import this module again as __mp_main__.
if __name__ == "__main__":
    main()
