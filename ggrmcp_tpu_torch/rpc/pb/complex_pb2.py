# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: complex.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rcomplex.proto\x12\x0b\x63omplexdemo\x1a\x1fgoogle/protobuf/timestamp.proto\"\xf8\x02\n\x07Profile\x12\x0f\n\x07user_id\x18\x01 \x01(\t\x12\x14\n\x0c\x64isplay_name\x18\x02 \x01(\t\x12&\n\x04tier\x18\x03 \x01(\x0e\x32\x18.complexdemo.AccountTier\x12.\n\ncreated_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x30\n\x06labels\x18\x05 \x03(\x0b\x32 .complexdemo.Profile.LabelsEntry\x12\x0f\n\x05\x65mail\x18\x06 \x01(\tH\x00\x12\x0f\n\x05phone\x18\x07 \x01(\tH\x00\x12,\n\x06postal\x18\x08 \x01(\x0b\x32\x1a.complexdemo.PostalAddressH\x00\x12\x15\n\x08nickname\x18\t \x01(\tH\x01\x88\x01\x01\x12\x0e\n\x06scores\x18\n \x03(\x01\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x42\t\n\x07\x63ontactB\x0b\n\t_nickname\">\n\rPostalAddress\x12\x0e\n\x06street\x18\x01 \x01(\t\x12\x0c\n\x04\x63ity\x18\x02 \x01(\t\x12\x0f\n\x07\x63ountry\x18\x03 \x01(\t\"R\n\x08TreeNode\x12\r\n\x05label\x18\x01 \x01(\t\x12\'\n\x08\x63hildren\x18\x02 \x03(\x0b\x32\x15.complexdemo.TreeNode\x12\x0e\n\x06weight\x18\x03 \x01(\x03\"$\n\x11GetProfileRequest\x12\x0f\n\x07user_id\x18\x01 \x01(\t\"=\n\x14UpsertProfileRequest\x12%\n\x07profile\x18\x01 \x01(\x0b\x32\x14.complexdemo.Profile\"8\n\x0fProfileResponse\x12%\n\x07profile\x18\x01 \x01(\x0b\x32\x14.complexdemo.Profile\"2\n\x0bTreeRequest\x12#\n\x04root\x18\x01 \x01(\x0b\x32\x15.complexdemo.TreeNode\"8\n\x0cTreeResponse\x12\x12\n\nnode_count\x18\x01 \x01(\x05\x12\x14\n\x0ctotal_weight\x18\x02 \x01(\x03*p\n\x0b\x41\x63\x63ountTier\x12\x1c\n\x18\x41\x43\x43OUNT_TIER_UNSPECIFIED\x10\x00\x12\x15\n\x11\x41\x43\x43OUNT_TIER_FREE\x10\x01\x12\x14\n\x10\x41\x43\x43OUNT_TIER_PRO\x10\x02\x12\x16\n\x12\x41\x43\x43OUNT_TIER_ADMIN\x10\x03\x32\xae\x01\n\x0eProfileService\x12J\n\nGetProfile\x12\x1e.complexdemo.GetProfileRequest\x1a\x1c.complexdemo.ProfileResponse\x12P\n\rUpsertProfile\x12!.complexdemo.UpsertProfileRequest\x1a\x1c.complexdemo.ProfileResponse2M\n\x0bTreeService\x12>\n\x07\x41nalyze\x12\x18.complexdemo.TreeRequest\x1a\x19.complexdemo.TreeResponse2X\n\rStreamService\x12G\n\x05Watch\x12\x1e.complexdemo.GetProfileRequest\x1a\x1c.complexdemo.ProfileResponse0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'complex_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PROFILE_LABELSENTRY._options = None
  _PROFILE_LABELSENTRY._serialized_options = b'8\001'
  _ACCOUNTTIER._serialized_start=859
  _ACCOUNTTIER._serialized_end=971
  _PROFILE._serialized_start=64
  _PROFILE._serialized_end=440
  _PROFILE_LABELSENTRY._serialized_start=371
  _PROFILE_LABELSENTRY._serialized_end=416
  _POSTALADDRESS._serialized_start=442
  _POSTALADDRESS._serialized_end=504
  _TREENODE._serialized_start=506
  _TREENODE._serialized_end=588
  _GETPROFILEREQUEST._serialized_start=590
  _GETPROFILEREQUEST._serialized_end=626
  _UPSERTPROFILEREQUEST._serialized_start=628
  _UPSERTPROFILEREQUEST._serialized_end=689
  _PROFILERESPONSE._serialized_start=691
  _PROFILERESPONSE._serialized_end=747
  _TREEREQUEST._serialized_start=749
  _TREEREQUEST._serialized_end=799
  _TREERESPONSE._serialized_start=801
  _TREERESPONSE._serialized_end=857
  _PROFILESERVICE._serialized_start=974
  _PROFILESERVICE._serialized_end=1148
  _TREESERVICE._serialized_start=1150
  _TREESERVICE._serialized_end=1227
  _STREAMSERVICE._serialized_start=1229
  _STREAMSERVICE._serialized_end=1317
# @@protoc_insertion_point(module_scope)
