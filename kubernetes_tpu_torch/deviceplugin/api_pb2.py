# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tapi.proto\x12\x12tpudeviceplugin.v1\"\x07\n\x05\x45mpty\"/\n\nPluginInfo\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"\xb1\x01\n\x0bTpuChipSpec\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06health\x18\x02 \x01(\t\x12\x0e\n\x06\x63oords\x18\x03 \x03(\x05\x12\x43\n\nattributes\x18\x04 \x03(\x0b\x32/.tpudeviceplugin.v1.TpuChipSpec.AttributesEntry\x1a\x31\n\x0f\x41ttributesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x8f\x01\n\x0eTopologyUpdate\x12\x11\n\tchip_type\x18\x01 \x01(\t\x12\x10\n\x08slice_id\x18\x02 \x01(\t\x12\x12\n\nmesh_shape\x18\x03 \x03(\x05\x12\x14\n\x0cworker_index\x18\x04 \x01(\x05\x12.\n\x05\x63hips\x18\x05 \x03(\x0b\x32\x1f.tpudeviceplugin.v1.TpuChipSpec\"]\n\x0f\x41\x64mitPodRequest\x12\x15\n\rpod_namespace\x18\x01 \x01(\t\x12\x10\n\x08pod_name\x18\x02 \x01(\t\x12\x0f\n\x07pod_uid\x18\x03 \x01(\t\x12\x10\n\x08\x63hip_ids\x18\x04 \x03(\t\"3\n\x10\x41\x64mitPodResponse\x12\x0f\n\x07\x61llowed\x18\x01 \x01(\x08\x12\x0e\n\x06reason\x18\x02 \x01(\t\"z\n\x14InitContainerRequest\x12\x15\n\rpod_namespace\x18\x01 \x01(\t\x12\x10\n\x08pod_name\x18\x02 \x01(\t\x12\x0f\n\x07pod_uid\x18\x03 \x01(\t\x12\x16\n\x0e\x63ontainer_name\x18\x04 \x01(\t\x12\x10\n\x08\x63hip_ids\x18\x05 \x03(\t\"E\n\x05Mount\x12\x16\n\x0e\x63ontainer_path\x18\x01 \x01(\t\x12\x11\n\thost_path\x18\x02 \x01(\t\x12\x11\n\tread_only\x18\x03 \x01(\x08\"L\n\nDeviceSpec\x12\x16\n\x0e\x63ontainer_path\x18\x01 \x01(\t\x12\x11\n\thost_path\x18\x02 \x01(\t\x12\x13\n\x0bpermissions\x18\x03 \x01(\t\"\xe8\x02\n\x15InitContainerResponse\x12\x41\n\x04\x65nvs\x18\x01 \x03(\x0b\x32\x33.tpudeviceplugin.v1.InitContainerResponse.EnvsEntry\x12)\n\x06mounts\x18\x02 \x03(\x0b\x32\x19.tpudeviceplugin.v1.Mount\x12/\n\x07\x64\x65vices\x18\x03 \x03(\x0b\x32\x1e.tpudeviceplugin.v1.DeviceSpec\x12O\n\x0b\x61nnotations\x18\x04 \x03(\x0b\x32:.tpudeviceplugin.v1.InitContainerResponse.AnnotationsEntry\x1a+\n\tEnvsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\xeb\x02\n\x0fTpuDevicePlugin\x12J\n\rGetPluginInfo\x12\x19.tpudeviceplugin.v1.Empty\x1a\x1e.tpudeviceplugin.v1.PluginInfo\x12O\n\x0cListAndWatch\x12\x19.tpudeviceplugin.v1.Empty\x1a\".tpudeviceplugin.v1.TopologyUpdate0\x01\x12U\n\x08\x41\x64mitPod\x12#.tpudeviceplugin.v1.AdmitPodRequest\x1a$.tpudeviceplugin.v1.AdmitPodResponse\x12\x64\n\rInitContainer\x12(.tpudeviceplugin.v1.InitContainerRequest\x1a).tpudeviceplugin.v1.InitContainerResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TPUCHIPSPEC_ATTRIBUTESENTRY._options = None
  _TPUCHIPSPEC_ATTRIBUTESENTRY._serialized_options = b'8\001'
  _INITCONTAINERRESPONSE_ENVSENTRY._options = None
  _INITCONTAINERRESPONSE_ENVSENTRY._serialized_options = b'8\001'
  _INITCONTAINERRESPONSE_ANNOTATIONSENTRY._options = None
  _INITCONTAINERRESPONSE_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=33
  _EMPTY._serialized_end=40
  _PLUGININFO._serialized_start=42
  _PLUGININFO._serialized_end=89
  _TPUCHIPSPEC._serialized_start=92
  _TPUCHIPSPEC._serialized_end=269
  _TPUCHIPSPEC_ATTRIBUTESENTRY._serialized_start=220
  _TPUCHIPSPEC_ATTRIBUTESENTRY._serialized_end=269
  _TOPOLOGYUPDATE._serialized_start=272
  _TOPOLOGYUPDATE._serialized_end=415
  _ADMITPODREQUEST._serialized_start=417
  _ADMITPODREQUEST._serialized_end=510
  _ADMITPODRESPONSE._serialized_start=512
  _ADMITPODRESPONSE._serialized_end=563
  _INITCONTAINERREQUEST._serialized_start=565
  _INITCONTAINERREQUEST._serialized_end=687
  _MOUNT._serialized_start=689
  _MOUNT._serialized_end=758
  _DEVICESPEC._serialized_start=760
  _DEVICESPEC._serialized_end=836
  _INITCONTAINERRESPONSE._serialized_start=839
  _INITCONTAINERRESPONSE._serialized_end=1199
  _INITCONTAINERRESPONSE_ENVSENTRY._serialized_start=1104
  _INITCONTAINERRESPONSE_ENVSENTRY._serialized_end=1147
  _INITCONTAINERRESPONSE_ANNOTATIONSENTRY._serialized_start=1149
  _INITCONTAINERRESPONSE_ANNOTATIONSENTRY._serialized_end=1199
  _TPUDEVICEPLUGIN._serialized_start=1202
  _TPUDEVICEPLUGIN._serialized_end=1565
# @@protoc_insertion_point(module_scope)
