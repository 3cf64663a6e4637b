"""``python -m atropos_tpu`` entry point."""
import sys

from atropos_tpu import check_importability, configure_compile_cache
from atropos_tpu.commands import execute_cli


def main():
    check_importability()
    configure_compile_cache()
    sys.exit(execute_cli(sys.argv[1:]))


if __name__ == "__main__":
    main()
