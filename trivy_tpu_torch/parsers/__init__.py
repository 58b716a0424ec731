"""Lockfile/binary dependency parsers (reference pkg/dependency/parser/*):
each parse_* takes file content and returns a list of Package.

Copy of trivy_tpu/parsers/__init__.py.
"""
