"""Training: the listeners and the CLI entry point.

Import the submodules directly (`train.listeners`, `train.cli`); this
package imports none of them eagerly.
"""
