"""Command-line entry point for vilma-tpu.

Exposes the same four subcommands as the reference CLI (reference
frontend.py:14-20) with the shared --logfile/--verbose flags every
subcommand accepts (reference frontend.py:49-62). Subcommand modules are
registered by name; building the parser imports each one for its args()
builder (argparse needs every subparser up front), while the heavy
numerical imports live inside the commands' main() bodies.
"""
import logging
import sys
from argparse import ArgumentParser
from importlib import import_module

from vilma_tpu import VERSION

# name -> module under vilma_tpu.commands; each module exposes
# args(subparsers) -> parser and main(namespace)
SUBCOMMANDS = ('make_ld_schema', 'check_ld_schema', 'sim', 'fit')


def _command_module(name):
    return import_module('vilma_tpu.commands.' + name)


def _attach_shared_flags(parser):
    parser.add_argument(
        '--logfile', required=False, type=str, default='',
        help='File to store information about the run. To print to '
             'stdout use "-". Defaults to no logging.')
    parser.add_argument(
        '--verbose', dest='verbose', action='store_true',
        help='Log all information (as opposed to just warnings)')


def build_parser():
    """The full CLI parser plus a name -> main-function dispatch map."""
    parser = ArgumentParser(
        description='vilma-tpu v%s uses variational inference to estimate '
                    'variant effect sizes from GWAS summary data while '
                    'simultaneously learning the overall distribution of '
                    'effects, accelerated via JAX/XLA.' % VERSION,
        usage='vilma-tpu <command> <options>')
    subparsers = parser.add_subparsers(title='Commands', dest='command')
    dispatch = {}
    for name in SUBCOMMANDS:
        module = _command_module(name)
        _attach_shared_flags(module.args(subparsers))
        dispatch[name] = module.main
    return parser, dispatch


def _start_logging(logfile, verbose):
    """Reference logging contract: --verbose selects DEBUG over WARNING;
    --logfile '-' is stdout-ish basicConfig, a path logs to that file, and
    empty disables logging entirely (reference frontend.py:64-73)."""
    level = logging.DEBUG if verbose else logging.WARNING
    if logfile == '-':
        logging.basicConfig(level=level)
    elif logfile:
        logging.basicConfig(filename=logfile, level=level)


def main(argv=None):
    parser, dispatch = build_parser()
    args = parser.parse_args(argv)
    run = dispatch.get(args.command)
    if run is None:
        parser.print_help()
        sys.exit(0)
    _start_logging(args.logfile, args.verbose)
    from vilma_tpu.utils.cache import configure_compile_cache
    configure_compile_cache()
    run(args)


if __name__ == '__main__':
    main()
