"""Guest disk and filesystem readers of the `vm` scan (reference
pkg/fanal/vm): disk.py, ext4.py, xfs.py, ebs.py. Device-free.
"""
