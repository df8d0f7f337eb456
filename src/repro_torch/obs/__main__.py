from repro_torch.obs.cli import main

raise SystemExit(main())
