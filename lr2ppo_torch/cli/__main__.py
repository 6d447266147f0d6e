"""`python -m lr2ppo_torch.cli <entry> [--flags...]`: runs the entry's
main on the flags; with no entry it prints the usage and exits 2, with -h
it prints it and exits 0, and an unknown entry exits 2."""

import importlib
import sys

from lr2ppo_torch.cli import ENTRY_POINTS


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m lr2ppo_torch.cli <entry> [--flags...]\n"
              "entries: " + ", ".join(ENTRY_POINTS))
        sys.exit(0 if len(sys.argv) >= 2 else 2)
    name = sys.argv[1]
    if name not in ENTRY_POINTS:
        print(f"unknown entry '{name}'; choose from: "
              + ", ".join(ENTRY_POINTS))
        sys.exit(2)
    importlib.import_module(f"lr2ppo_torch.cli.{name}").main(sys.argv[2:])


if __name__ == "__main__":
    main()
