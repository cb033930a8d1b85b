from .mesh import default_devices, device_count, sharded_score_tasks
