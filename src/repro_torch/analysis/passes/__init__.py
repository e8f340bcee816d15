"""fleetlint passes — importing a module registers its pass."""
