"""The modes a traffic file names: ``train`` and ``predict``."""
