from .headless import main

raise SystemExit(main())
