from optix_renderer_tpu_torch.cli import main

raise SystemExit(main())
