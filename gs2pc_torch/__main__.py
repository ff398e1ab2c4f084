from gs2pc_torch.cli import main

main()
